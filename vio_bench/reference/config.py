"""Static configuration tree for the VIO pipeline (the port's own copy of
``larvio_tpu/config.py``: the same frozen dataclasses, fields and defaults).

The whole configuration is one frozen, hashable dataclass tree: every
shape-determining knob (clone window size, feature-table size, IMU slots per
frame, image size) lives here, and the port caches per-config device
constants with ``functools.lru_cache(cfg)``. The benchmark builds it from
a configuration file's ``vio`` dict (``port.build_cfg``).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Tuple


# ---------------------------------------------------------------------------
# camera
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class CameraConfig:
    """Pinhole camera + distortion model (ref: image_processor loadParameters).

    ``distortion_model`` is one of ``"radtan"`` (radial-tangential, 4 coeffs)
    or ``"equidistant"`` (Kannala-Brandt fisheye, 4 coeffs) — both supported by
    the reference (SURVEY.md §2, BASELINE.json:10 UZH-FPV fisheye config).
    """

    width: int = 752
    height: int = 480
    # intrinsics [fu, fv, cu, cv]
    intrinsics: Tuple[float, float, float, float] = (458.654, 457.296, 367.215, 248.375)
    distortion_model: str = "radtan"
    # radtan: [k1, k2, p1, p2]; equidistant: [k1, k2, k3, k4]
    distortion_coeffs: Tuple[float, float, float, float] = (
        -0.28340811,
        0.07395907,
        0.00019359,
        1.76187114e-05,
    )
    # T_cam_imu: rotation (row-major 3x3) and translation, mapping IMU-frame
    # points into the camera frame: p_c = R_ci @ p_i + t_ci  (Kalibr convention)
    R_cam_imu: Tuple[float, ...] = (
        0.014865542981794,
        0.999557249008346,
        -0.025774436697440,
        -0.999880929698575,
        0.014967213324719,
        0.003756188357967,
        0.004140296794224,
        0.025715529947966,
        0.999660727177902,
    )
    t_cam_imu: Tuple[float, float, float] = (
        0.065222909535531,
        -0.020706385492719,
        -0.008054602460030,
    )


# ---------------------------------------------------------------------------
# IMU / process noise
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class NoiseConfig:
    """Continuous-time IMU noise densities (ref: imu_state.h static members)."""

    gyro_noise: float = 0.005  # rad/s/sqrt(Hz)
    acc_noise: float = 0.05  # m/s^2/sqrt(Hz)
    gyro_bias_noise: float = 0.001  # rad/s^2/sqrt(Hz)
    acc_bias_noise: float = 0.01  # m/s^3/sqrt(Hz)
    # pixel observation noise (std, normalized-plane units = px / focal)
    observation_noise: float = 0.035


# ---------------------------------------------------------------------------
# front-end
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class FrontendConfig:
    """Feature-tracking front-end (ref: ImageProcessor, SURVEY.md §3.2).

    All sizes are static: the feature table has exactly ``max_features`` slots
    with an alive mask; the detection grid is ``grid_rows x grid_cols`` with a
    per-cell cap — the reference's dynamic per-cell vectors become fixed slot
    ranges.
    """

    max_features: int = 200
    grid_rows: int = 4
    grid_cols: int = 5
    grid_min_feature_num: int = 3
    grid_max_feature_num: int = 10
    pyramid_levels: int = 3
    patch_size: int = 15
    fast_threshold: float = 15.0  # detector response threshold (grayscale units)
    max_iteration: int = 12  # LK Gauss-Newton iterations per level
    track_precision: float = 0.01  # LK convergence threshold (px)
    ransac_threshold: float = 3.0  # px, two-point RANSAC inlier gate
    ransac_hypotheses: int = 64  # fixed hypothesis count (vectorized RANSAC)
    # Hamming gate for the descriptor check (vs the descriptor stored at
    # track birth, computed on the _desc_blur'd image). 60 is measured, not
    # arbitrary: with blurred descriptors, noisy-workload TRUE tracks sit at
    # p50 ~26 / p90 ~51 at age 0 (tools/diag_track_death.py), so 60 passes
    # them; raising to 72 admitted a 60-72 band of genuinely-slid LK tracks
    # and degraded clean-pixel image ATE 0.011 -> 0.059 — above 60 the
    # distance measures track slide, which is exactly what the gate is for.
    orb_distance_threshold: int = 60
    min_distance: int = 15  # min spacing between detected corners (px)
    use_pallas_lk: bool = True  # Pallas LK kernel on TPU (XLA path elsewhere)


# ---------------------------------------------------------------------------
# filter (back-end)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class FilterConfig:
    """Hybrid-MSCKF estimator (ref: larvio.h loadParameters, SURVEY.md §3.3).

    Error-state layout (fixed, padded — SURVEY.md §7 layer 4):

    ``[ imu(15) | extrinsic(6) | td(1) | clones(6 x max_clones) | slam(3 x max_slam) ]``

    imu block: [dtheta(3), dbg(3), dv(3), dba(3), dp(3)].
    Each clone block: [dtheta_c(3), dp_c(3)].
    """

    max_clones: int = 20
    # Hybrid SLAM feature slots (0 = pure MSCKF). This is a CONSISTENCY knob,
    # not only a capacity one: promotion candidates are ranked by observation
    # count (msckf._consume_blocks top_k), so a small slot budget admits only
    # the best-observed (longest-baseline) tracks, whose FEJ-frozen
    # triangulation error is smallest. The r5 20-seed exact-noise sweep over
    # the cap (obs floor 12, no other maturity gate): 12 slots -> horizontal
    # position NEES ~19-21; 6 slots -> [0.71, 0.84, 0.55], worst-seed error
    # 0.354 m, flat NEES-over-time quarters — matching the quality of
    # full-window-count promotion (the r4 fix) WITHOUT its image-level
    # starvation (real LK tracks drop frames and never cover 20/20 clones;
    # n_slam 0.6 and bench ATE 0.141 at count=20 vs 1.7 / green here).
    # Deliberate scarcity also bounds how much FEJ-frozen landmark
    # information can pin the pose at once.
    max_slam_features: int = 6
    # Minimum observation COUNT before a track may promote to an in-state
    # slam landmark — a floor only; selection pressure from the slot budget
    # above is what keeps promotion quality high. (r5 sweep: with 12 slots
    # this floor alone measured NEES ~20 at exact noise — a floor does not
    # select. Span/window-completeness maturity gates were tried in r4-r5
    # and DELETED: absolute-span thresholds were non-monotonic cliffs —
    # span 30 failed NEES ~21, 40 passed ~2.6, 48+ failed ~4-6 with 3x yaw
    # degradation — and window-completeness starved image-level promotion,
    # the r4 shipped regression.)
    slam_promote_obs: int = 12
    # promote only if the initialized inverse-depth sigma is below this (1/m);
    # the bearing gate is fixed (slam._MAX_AB_SIGMA). Inverse depth keeps this
    # unit-correct for near AND far features (a metric depth gate starves
    # distant landmarks whose depth variance grows quadratically)
    slam_max_init_rho_sigma: float = 0.25
    # floor (std) on the observation noise used for a landmark's DELAYED-INIT
    # covariance only (models/slam.py promote_features): fresh triangulations
    # carry linearization bias that does not shrink with the sensor noise, so
    # a tightly-modeled sigma makes the init ~sigma^2-overconfident and the
    # slam updates then pin the state to biased landmarks (~1 m bootstrap
    # drift at exactly-matched 0.002). Inactive at the conservative default
    # observation noise.
    slam_init_noise_floor: float = 0.01
    # consistency-aware delayed init (ROADMAP r3 #4 lead): inflate ONLY the
    # inverse-depth (rho) variance of a fresh landmark by k^2 x its own
    # delayed-init rho variance. Triangulation-linearization bias concentrates
    # along the anchor ray (rho); ray-directed inflation keeps the bearing
    # components honest while de-weighting the biased direction, unlike
    # slam_init_noise_floor's isotropic measurement-space floor. In sigma
    # units: the landmark's initial rho sigma is scaled by sqrt(1 + k^2).
    # 0 disables.
    slam_init_rho_inflation: float = 0.0
    # Consume-channel width during BOOTSTRAP mode (post-reset / rough-init
    # re-convergence): the consume channel is the only correction source
    # before tracks die or the window fills, and its width sets the
    # re-convergence rate. The r5 slot-budget redesign (max_slam_features
    # 12 -> 6) silently halved it because _consume_blocks' top_k width was
    # tied to the slot budget — NaN-accel recovery ATE degraded 1.55 -> 4.75
    # (tools + tests/test_failure_recovery.py). Steady-state consumption
    # stays at the slot budget (that scarcity IS the consistency mechanism);
    # bootstrap widens to this many windows per frame, the extra ones
    # retiring as plain MSCKF marginalization. Takes effect when larger than
    # max_slam_features.
    bootstrap_consume_k: int = 12
    # lifetime cap (frames) on in-state slam features; 0 disables. Pure FEJ
    # freezes the promotion-time linearization error of a landmark into every
    # subsequent 2-row Jacobian; over a feature's (unbounded) lifetime those
    # slightly-biased updates compound into position overconfidence at
    # tightly-modeled noise (ROADMAP #4). Capping the lifetime drops the
    # feature and lets the still-alive track re-promote through the EXACT
    # delayed-init channel ~slam_promote_obs frames later — an honest,
    # covariance-consistent relinearization (unlike a bare null refresh,
    # which leaks observability — the r3 slam_relin_sigma ablation).
    # Default 20 (one window): with slam_promote_obs=20 alone the NEES
    # quarter-profile still creeps (0.8 -> 1.9 over 10 s); the cap flattens
    # it ([0.79, 0.64, 0.79, 0.96]) at no measured accuracy cost (r4 sweep).
    slam_max_lifetime: int = 20
    # landmark random walk (models/propagation._slam_frame_noise): per-sqrt(s)
    # std added to each in-state landmark's inverse depth (rho, 1/m units;
    # bearing gets 0.2x). Models the FEJ frozen-linearization error as slow
    # landmark drift so a long-lived slam feature cannot accumulate unbounded
    # information and anchor the pose overconfidently — the measured source
    # of the exact-noise horizontal-position NEES bias (ROADMAP #4). 0 = off.
    slam_process_noise: float = 0.0
    # relinearize a slam feature's FEJ null when the estimate has moved more
    # than this many feature-sigmas away from it (models/slam.py
    # relinearize_nulls): pure FEJ freezes the promotion-time triangulation
    # bias into every subsequent Jacobian, which at tightly-modeled noise
    # turns into a persistent position-overconfidence bias (ROADMAP r3 #4).
    # The threshold is in sigma units so converged features never churn their
    # linearization point. 0 disables (pure FEJ).
    slam_relin_sigma: float = 0.0
    imu_slots_per_frame: int = 24  # padded IMU samples per camera frame
    # Vision-time gate (s): a frame's vision is consumed only if propagation
    # actually reached the image time, fs.time >= t_img + td - tol. During an
    # IMU blackout the state freezes while the camera keeps moving; a clone
    # stamped then pairs the frame's observations with a stale pose and slam
    # rows read the motion gap as landmark innovation — measured: a 3-frame
    # (150 ms) blackout seeds a slow divergence that vision never unwinds
    # (tests/test_e2e_sim.py::test_imu_gap_robustness). The reference buffers
    # images until IMU catches up (ref: larvio imgCallback/imuCallback sync);
    # in a fixed-slot scan, dropping the frame's vision is the honest
    # analogue. Nominal lag is 0 (propagation clamps at t_img + td when the
    # frame's IMU slots cover it), so 20 ms distinguishes "short a tail
    # sample" (keep) from "missed a frame of IMU" (drop).
    vision_time_tol: float = 0.02
    max_update_features: int = 24  # max dead tracks per MSCKF update batch
    max_prune_features: int = 24  # max features marginalized per prune event
    estimate_extrinsic: bool = True
    estimate_td: bool = True
    td_initial: float = 0.0
    # initialization priors (1-sigma) for the online-calibrated states
    # (ref: LarVio ctor extrinsic/td covariance seeds). The defaults assume a
    # Kalibr-grade extrinsic; widen them when bootstrapping from a rough
    # hand-measured extrinsic so the filter is licensed to move it
    # (tests/test_extrinsic.py exercises a 2 deg / 2 cm bootstrap).
    prior_extrinsic_rot_std: float = 3.5e-3  # rad
    prior_extrinsic_trans_std: float = 1.0e-2  # m
    prior_td_std: float = 2.5e-2  # s
    # triangulation
    tri_max_iterations: int = 6
    # Per-observation outlier trim: observations whose reprojection residual
    # at the triangulated point exceeds tri_trim_k x the window's own robust
    # scale (mean residual, floored at tri_trim_floor) are DROPPED from the
    # consumed/marginalized measurement block
    # (msckf._consume_blocks/_marginalization_blocks). The scale SELF-SCALES
    # on the window's residuals — deliberately NOT on the modeled observation
    # noise, whose conservative default carries a ~2.5x safety factor that
    # would mask gross outliers — and during bootstrap the window's residuals
    # are uniformly large (pose inconsistency, not bad matches), which keeps
    # the trim inert. Rationale: the block-level Huber in
    # update.feature_block acts on the PROJECTED rows, after Householder
    # elimination has already smeared a gross outlier across the whole
    # block, so it cannot excise it; with a small slam slot budget one
    # outlier-poisoned promoted landmark carries 1/S of the slam information
    # (measured on the test_consistency.py outlier workload, 3% gross
    # mismatches: ATE 0.166 at 6 slots / 0.067 at 12 before the trim).
    # The GN triangulation itself stays least-squares — see the
    # models/triangulation.py tail note. 0 disables.
    tri_trim_k: float = 4.0
    tri_trim_floor: float = 0.005
    tri_translation_threshold: float = 0.2  # checkMotion baseline gate (m)
    tri_max_depth: float = 60.0
    tri_min_depth: float = 0.2
    tri_max_reproj_err: float = 0.05  # steady-state bound; widens automatically
    # while velocity uncertainty is high (see msckf._tri_err_bound)
    # gating
    chi2_confidence: float = 0.95
    # self-scaling Huber: rows beyond huber_k x the feature's robust residual
    # scale (floored at the observation sigma) are downweighted; 0 disables.
    # (the reference uses a fixed huber_epsilon; the self-scaling form stays
    # neutral during post-init transients where all residuals are large)
    huber_k: float = 2.5
    # ZUPT (ref: CJA 2020 closed-form zero velocity update)
    enable_zupt: bool = True
    zupt_max_feature_dis: float = 2e-3  # normalized-plane mean track motion gate
    # sigma of the v=0 pseudo-measurement. Kept of the order of the smallest
    # velocity the image-motion detector can actually certify
    # (threshold * scene depth / frame dt), so a false-positive detection at
    # slow speed cannot clamp the state inconsistently.
    zupt_noise_v: float = 1e-1  # m/s
    # IMU-stillness gates combined with the image test (a slow smooth ramp is
    # invisible to the image at depth, but shows up in the gyro immediately)
    zupt_max_gyro: float = 1.5e-2  # rad/s, max |w - bg| over the frame
    zupt_max_acc_dev: float = 3e-1  # m/s^2, max | |a - ba| - g |
    zupt_noise_p: float = 1e-2  # m
    zupt_noise_q: float = 3.4e-2  # rad
    # online reset (ref: onlineReset(), SURVEY.md §5 failure detection)
    position_std_threshold: float = 8.0
    # post-reset priors (1-sigma) for calibration states that SURVIVED the
    # fault finite — tight-but-adaptive values keep the hard-won calibration
    # while the fast states re-converge (rationale + measured trade-offs in
    # msckf.py's reset block; pinned by tests/test_failure_recovery.py)
    reset_rp_std: float = 0.03  # roll/pitch when q survived (rad)
    reset_yaw_std: float = 0.1  # yaw when q survived (rad)
    reset_bg_std: float = 0.01  # gyro bias when bg survived (rad/s)
    reset_ba_std: float = 0.05  # accel bias when ba survived (m/s^2)
    reset_td_std: float = 5e-3  # td when td survived (s)
    # roll/pitch prior when attitude did NOT survive and the restart is
    # seeded from the accelerometer's gravity direction (tilt error of the
    # seed ~ |a_linear|/g; see msckf.py reset block). Keep this TIGHT: the
    # re-bootstrap must re-learn monocular scale from the accelerometer, and
    # a wide roll/pitch prior lets the filter explain the scale-induced accel
    # residual as tilt instead (observed: at 0.2 rad the restart locks in a
    # ~2x scale error with ba absorbing the periodic residual; at 0.05 rad
    # the same fault recovers)
    reset_accel_seed_rp_std: float = 0.05  # rad
    # triangulation-residual acceptance bound while in bootstrap mode (the
    # steady-state bound is tri_max_reproj_err; see msckf._tri_err_bound)
    bootstrap_tri_err_bound: float = 0.3
    # pruning
    redundancy_angle_threshold: float = 0.2618  # rad (~15 deg)
    redundancy_distance_threshold: float = 0.4  # m
    # initialization
    static_init_samples: int = 200  # IMU samples for static initialization
    static_init_accel_var: float = 0.25  # stationarity gate on |a| variance
    # static-init image stillness gate: window-mean of the front-end's
    # per-frame mean normalized-plane track displacement must stay below
    # this. REQUIRED evidence alongside the accel gate (constant-velocity
    # translation is IMU-indistinguishable from rest). Sits between the
    # tracking noise floor (~0.0035 at 0.002-normalized pixel noise) and the
    # slowest real motion of interest (~0.0065 at 1 m/s, 5-10 m scene);
    # deliberately looser than zupt_max_feature_dis, whose false-negative
    # cost is just a skipped ZUPT rather than a v=0 init mid-motion.
    static_init_max_feature_dis: float = 5e-3
    # bootstrap: while velocity uncertainty is above this, consume the longest
    # live tracks every frame (marginalizing MSCKF updates without waiting for
    # track death or a full window) — the correction channel right after a
    # rough dynamic initialization or an online reset
    # the bootstrap channel arms only while the clone window is still
    # rebuilding (post-dynamic-init / post-reset) AND velocity uncertainty is
    # high — normal operation always has a full window, so transient variance
    # spikes in weakly-constrained geometries cannot trigger it
    bootstrap_vel_var: float = 9e-2  # (0.3 m/s)^2
    bootstrap_min_obs: int = 5
    # measurement underweighting while in bootstrap mode (variance multiplier
    # on the vision observation noise): the first updates after a reset carry
    # ~m/s-level velocity residuals whose linearization error otherwise
    # overshoots into roll/pitch (degrees of injected tilt -> gravity leak).
    # Softening them trades a few extra frames of velocity convergence for an
    # attitude that stays at its gyro-integrated accuracy. 1.0 disables.
    bootstrap_noise_inflation: float = 4.0
    # absolute floor (std, normalized plane) on the EFFECTIVE observation
    # noise while velocity uncertainty is high: with tightly-modeled noise
    # (e.g. 0.002 exactly matching the sensor) the bootstrap-phase updates
    # are weighted ~300x the default and their linearization error (loose
    # triangulations against a still-converging window) is baked into the
    # state at collapsed covariance — observed as ~1 m position error
    # acquired in the first 2 s and "known" to 3 cm. The floor keeps the
    # transient updates honest about linearization error without touching
    # steady-state weighting.
    bootstrap_noise_floor: float = 0.01
    # numerics
    use_fej: bool = True
    # square-root covariance (SURVEY.md §7 hard part #2): fs.P holds a square
    # factor S with P = S S^T. Updates/propagation re-compress stacked factors
    # (core/linalg.psd_factor) so the implied covariance is PSD by
    # construction — eliminating the f32 Joseph-form collapse class (negative
    # diagonals under tightly-modeled observation noise) instead of detecting
    # it after the fact. DEFAULT since round 3: accuracy parity is pinned by
    # tests/test_sqrt_filter.py (ATE identical, strictly better consistency —
    # 0 resets at exactly-matched noise where Joseph collapses twice), the
    # measured TPU cost is -1.7% fps, and the full suite soaks under it.
    # False selects the Joseph-form path (the r1/r2 baseline).
    sqrt_form: bool = True


@dataclass(frozen=True)
class VioConfig:
    camera: CameraConfig = field(default_factory=CameraConfig)
    noise: NoiseConfig = field(default_factory=NoiseConfig)
    frontend: FrontendConfig = field(default_factory=FrontendConfig)
    filter: FilterConfig = field(default_factory=FilterConfig)
    gravity: float = 9.81

    def replace(self, **kw: Any) -> "VioConfig":
        return dataclasses.replace(self, **kw)
