"""Chi-square inverse-CDF table for Mahalanobis gating.

The same numpy table as ``larvio_tpu/core/chi2.py`` (scipy's ``chi2.ppf`` when
scipy is installed, else the Wilson-Hilferty approximation), indexed by
(masked, possibly tensor-valued) degrees of freedom.
"""

from __future__ import annotations

import numpy as np
import torch

from vio_bench.reference.core.device import device_array

_MAX_DOF = 512


try:  # pragma: no cover - scipy may not exist; use pure approximation
    from scipy.stats import chi2 as _scipy_chi2  # type: ignore

    def _table(p: float) -> np.ndarray:
        return _scipy_chi2.ppf(p, np.arange(1, _MAX_DOF + 1)).astype(np.float32)

except Exception:  # pure numpy Wilson-Hilferty (max rel. err ~0.3% at dof=1)

    def _table(p: float) -> np.ndarray:
        from statistics import NormalDist

        zp = NormalDist().inv_cdf(p)
        k = np.arange(1, _MAX_DOF + 1, dtype=np.float64)
        x = k * (1.0 - 2.0 / (9.0 * k) + zp * np.sqrt(2.0 / (9.0 * k))) ** 3
        x[0] = zp**2 if p == 0.5 else NormalDist().inv_cdf((p + 1) / 2) ** 2
        x[1] = -2.0 * np.log(1.0 - p)
        return x.astype(np.float32)


_TABLE_95 = _table(0.95)
_TABLE_99 = _table(0.99)


def chi2_inv95(dof: torch.Tensor) -> torch.Tensor:
    """chi2_{0.95} quantile for integer dof, clipped to the table."""
    return chi2_inv(dof, 0.95)


def chi2_inv(dof: torch.Tensor, confidence: float = 0.95) -> torch.Tensor:
    table = _TABLE_99 if confidence >= 0.99 else _TABLE_95
    idx = torch.clamp(dof.to(torch.int64) - 1, 0, _MAX_DOF - 1)
    return device_array(table, dof.device)[idx]
