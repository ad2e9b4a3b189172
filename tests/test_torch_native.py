"""The port's native CSV loader and IMU ring buffer
(``larvio_tpu_torch/utils/native.py`` over ``csrc/euroc_loader.cpp``)
against the JAX package's (``larvio_tpu/utils/native.py``) and
``np.loadtxt``.

Tolerances: every value equal bit for bit (``float64`` bit patterns, NaN
included); the ring's buckets equal exactly.
"""

import os

import numpy as np
import pytest

from larvio_tpu.utils import native as jnative
from larvio_tpu_torch.data import euroc as teuroc
from larvio_tpu_torch.utils import native as tnative

ROWS = [
    "1403636579758555392,-0.099134701513277898,0.14730578886832138,0.02722713633111154,"
    "8.1476917083333333,-0.37592158333333331,-2.4026292499999999",
    "1403636579763555584,nan,0.14311699248412068,0.025041936045070361,8.033280791666666,"
    "-0.40861041666666664,-2.4026292499999999",
    "1403636579768555520,-0.09773843840764462,1e-3,-3.25e+2,NaN,0.0,-0.0",
]


def _csv(path, newline: str, header: bool = True, blank: bool = True) -> str:
    lines = (["#timestamp [ns],w_x,w_y,w_z,a_x,a_y,a_z"] if header else []) + ROWS[:2]
    lines += ([""] if blank else []) + ["# a comment between rows", ROWS[2]]
    with open(path, "w", newline="") as f:
        f.write(newline.join(lines) + newline)
    return str(path)


def _bits(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a, np.float64).view(np.uint64)


@pytest.mark.parametrize("newline", ["\n", "\r\n"], ids=["lf", "crlf"])
@pytest.mark.parametrize("n_cols", [1, 4, 7])
def test_load_csv_equals_the_jax_loader_and_loadtxt(tmp_path, newline, n_cols):
    """``#`` comments (header and between rows), a blank row, CRLF endings,
    ``nan`` / ``NaN``, exponents, signed zero and the first ``n_cols``
    columns: the port, the JAX package's loader and ``np.loadtxt`` agree bit
    for bit."""
    path = _csv(tmp_path / "data.csv", newline)
    got = tnative.load_csv(path, n_cols)
    want = np.loadtxt(path, delimiter=",", comments="#", usecols=range(n_cols), ndmin=2)
    assert got.shape == want.shape == (3, n_cols) and got.dtype == np.float64
    np.testing.assert_array_equal(_bits(got), _bits(want))
    np.testing.assert_array_equal(_bits(got), _bits(jnative.load_csv(path, n_cols)))


def test_euroc_reader_parses_with_the_native_loader(tmp_path, monkeypatch):
    """``data/euroc.py`` reads its CSVs through ``load_csv``."""
    path = _csv(tmp_path / "data.csv", "\n")
    seen = []
    real = tnative.load_csv

    def spy(p, n):
        seen.append((p, n))
        return real(p, n)

    monkeypatch.setattr(teuroc, "load_csv", spy)
    got = teuroc._load_csv(path, 7)
    assert seen == [(path, 7)]
    np.testing.assert_array_equal(_bits(got), _bits(jnative.load_csv(path, 7)))


def test_load_csv_raises_where_it_cannot_read(tmp_path, monkeypatch):
    with pytest.raises(FileNotFoundError):
        tnative.load_csv(str(tmp_path / "missing.csv"), 3)
    with pytest.raises(ValueError, match="n_cols"):
        tnative.load_csv(_csv(tmp_path / "data.csv", "\n"), 0)
    # a failed build raises: there is no numpy fallback
    monkeypatch.setattr(tnative, "_libs", {})
    monkeypatch.setattr(tnative, "HOST_FLAGS", tnative.HOST_FLAGS + ["-DLARVIO_UNBUILT"])
    monkeypatch.setattr(tnative, "_compiler", lambda cxx: "false")
    with pytest.raises(RuntimeError, match="C\\+\\+ build failed"):
        tnative.load_csv(str(tmp_path / "data.csv"), 3)


@pytest.mark.parametrize("capacity", [4096, 50], ids=["roomy", "wrapped"])
def test_imu_ring_buckets_equal_the_jax_ring(capacity):
    """The same 200 Hz pushes (with a small ring, the oldest samples
    overwritten) and the same frame buckets, slots and margins: the port's
    and the JAX package's ``ImuRing`` return the same arrays exactly."""
    rng = np.random.default_rng(0)
    rings = [tnative.ImuRing(capacity), jnative.ImuRing(capacity)]
    t_prev = 0.0
    for k in range(12):
        for j in range(10):
            t = 0.05 * k + 0.005 * j + 1e-4 * rng.random()
            w, a = rng.normal(size=3), rng.normal(size=3) + [0, 0, 9.81]
            for r in rings:
                r.push(t, w, a)
        t_img = 0.05 * k + 0.03
        for slots, margin in ((24, 0.04), (6, 0.0)):
            got, want = (r.bucket(t_prev, t_img, slots, margin) for r in rings)
            for g, w_ in zip(got, want):
                assert g.dtype == w_.dtype and g.shape == w_.shape
                np.testing.assert_array_equal(g, w_)
        t_prev = t_img
    assert got[3].any()
    rings[0].close()
    rings[0].close()  # idempotent


def test_imu_ring_refuses_an_empty_ring():
    with pytest.raises(ValueError, match="capacity"):
        tnative.ImuRing(0)


def test_the_port_builds_its_own_copy_of_the_source():
    """The port compiles ``larvio_tpu_torch/csrc/euroc_loader.cpp``, whose
    code is the JAX package's ``native/euroc_loader.cpp`` below its header
    comment."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

    def body(path):
        text = open(os.path.join(repo, path)).read()
        return text[text.index("#include"):]

    assert body("larvio_tpu_torch/csrc/euroc_loader.cpp") == body("native/euroc_loader.cpp")
    assert tnative._CSV_SRC.name == "euroc_loader.cpp" and tnative._CSV_SRC.parent.name == "csrc"
