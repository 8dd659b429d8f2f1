"""The SLAM system's host state machine (port of
gf_orb_slam_tpu/pipeline/system.py with its synchronous semantics): two-view
initialization, per-frame tracking, keyframe decisions, the fused keyframe
insertion, and place recognition — the BoW vocabulary and keyframe
database, relocalization of a LOST system, and Sim(3) loop closing — with
the reference's loop instrumentation (`loop_gt_overlap`, `loop_events`,
`loop_probe_floor`, `loop_gate_events`; read by io_utils/loop_eval.py).

Left out of the port: the reference's pipelining for a remote accelerator
(frames in flight, deferred readback, eager finalize), because a local card
needs none. Where the reference defers an insertion's bookkeeping to the
next frame, the port reads it right after the insertion and runs the loop
check at the point of the next frame where the reference's synchronous run
does: after that frame's tracking step, before its result is read (or at
relocalization, compaction and `flush`).

Host reads: one packed copy of (ok, n_inliers, pose, n_total) per tracked
frame and the tracking step's own wide-radius branch; one packed copy of
(kf_id, culled_kf, n_ref) after each insertion, which also carries the loop
candidates and their covisibility rows once the map is old enough (and,
with `loop_gt_overlap` set, the query's covisibility row and the
keyframes' frame ids and validity); one of (ok, n_inliers, pose) per LOST
frame. Verifying a loop candidate reads its `ok` (in probe mode packed with
its funnel counts); the bootstrap and vocabulary training read freely.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field

import numpy as np
import torch
import torch.nn.functional as F

from gf_orb_slam_tpu_torch.geometry import quat, se3
from gf_orb_slam_tpu_torch.geometry.camera import CameraModel
from gf_orb_slam_tpu_torch.io_utils.timing import TimeLog
from gf_orb_slam_tpu_torch.loop import loop_closing
from gf_orb_slam_tpu_torch.mapping import frame as frame_mod
from gf_orb_slam_tpu_torch.mapping import map_state as ms
from gf_orb_slam_tpu_torch.ops import matching, orb
from gf_orb_slam_tpu_torch.ops.pyramid import level_consts
from gf_orb_slam_tpu_torch.pipeline import local_mapping
from gf_orb_slam_tpu_torch.pipeline import track_view as tv
from gf_orb_slam_tpu_torch.pipeline import tracking
from gf_orb_slam_tpu_torch.retrieval import keyframe_db as kdb
from gf_orb_slam_tpu_torch.retrieval import vocabulary as voc_mod
from gf_orb_slam_tpu_torch.solvers import initializer, local_ba

NO_CUDA = 'no CUDA device is available: pass device="cpu" (--device cpu on the command line) to run on the CPU'


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: `device`, or the first CUDA card
    when it is None. A CUDA device without a card raises; nothing falls back
    to the CPU unless the caller asks for it."""
    dev = torch.device(device) if device is not None else torch.device("cuda", 0)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(NO_CUDA)
    return dev


class State(enum.Enum):
    """Tracking state (Tracking.h eTrackingState)."""

    NO_IMAGES_YET = 0
    NOT_INITIALIZED = 1
    INITIALIZING = 2
    WORKING = 3
    LOST = 4


@dataclass
class SlamConfig:
    """The reference's SlamConfig, fields and defaults (place recognition
    on), without the pipelining fields."""

    n_features: int = 800
    n_levels: int = 8
    scale: float = 1.2
    fast_threshold: float = 20.0
    max_keyframes: int = 256
    max_points: int = 16384
    use_motion_model: bool = True
    use_gf: bool = False            # Good-Feature selection in local-map tracking
    gf_mode: str = "subset"         # one of tracking.GF_MODES: "subset" | "hybrid" |
                                    # "lazier" | "auto" | "active" | "random" | "longlive"
    gf_budget: int = 100
    gf_batch: int = 10              # picks per greedy round
    gf_warmup_frames: int = 40      # GF off for this many frames after init
    max_frames_between_kf: int = 12
    ba_window: int = 8              # local BA camera window
    ba_fixed: int = 2               # fixed boundary cameras in the window
    ba_points: int = 2048           # compacted local-point capacity for BA
    ba_iters: tuple = (5, 10)       # windowed-BA LM iterations per stage
    min_init_matches: int = 80
    init_min_points: int = 0        # >0: reject a bootstrap whose second
                                    # keyframe keeps fewer BA inliers
    triangulate_neighbors: int = 3
    # place recognition / loop closing
    enable_loop_closing: bool = True
    enable_relocalization: bool = True
    vocab_k: int = 10
    vocab_L: int = 3
    vocab_train_kfs: int = 4
    loop_min_kf_gap: int = 10
    loop_probe_floor: int = 0       # >0: instrumentation mode — candidates
                                    # from streak 2 are verified with the
                                    # Sim3-RANSAC floor lowered to this, so
                                    # that borderline ones still run the
                                    # re-match and OptimizeSim3 and their
                                    # funnel counts land in loop_gate_events;
                                    # a loop is accepted by the shipped rule
                                    # (streak ≥ 3, ≥ 20 / ≥ 20 inliers) either way
    view_size: int = 4096           # local-map tracking view capacity
    max_lost_frames: int = 100

    def __post_init__(self):
        tracking.check_gf_mode(self.gf_mode)
        tv.check_keyframe_capacity(self.max_keyframes)


@dataclass
class FrameLog:
    timestamp: float
    state: str
    pose_cw: np.ndarray | None
    n_inliers: int
    timing_ms: dict = field(default_factory=dict)


class SlamSystem:
    def __init__(self, cam: CameraModel, cfg: SlamConfig | None = None, device=None, seed: int = 0):
        cfg = cfg or SlamConfig()
        tracking.check_gf_mode(cfg.gf_mode)  # fields set after construction
        tv.check_keyframe_capacity(cfg.max_keyframes)
        self.cam = cam
        self.cfg = cfg
        self.device = resolve_device(device)
        self.orb_cfg = orb.OrbConfig(
            n_features=cfg.n_features, n_levels=cfg.n_levels, scale=cfg.scale,
            fast_threshold=cfg.fast_threshold,
        )
        # Initialization extractor with 2x features, whose frames become the
        # first two keyframes; the map's keypoint capacity is sized for it.
        self.init_orb_cfg = self.orb_cfg._replace(n_features=2 * cfg.n_features)
        # The initializer's, PnP's and Sim3 RANSAC's samples and the random
        # GF modes' noise come from this generator; JAX's threefry stream
        # cannot be reproduced, so runs are compared statistically (or with
        # injected samples).
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self.state = State.NO_IMAGES_YET
        self.map = self._empty_map()
        self.frame_id = 0
        self.last_kf_frame = 0
        self.last_reloc_frame = -(10**9)
        self.init_frame = None
        self.init_ts = None
        self.last_frame = None
        self.last_obs = None
        self.last_pose = None
        self.last_ts = None
        self.velocity = None         # (7,) relative pose T_cur_last
        self.n_ref_tracked = 0
        self.n_kf = 0
        self.trajectory: list[tuple[float, np.ndarray]] = []
        self.logs: list[FrameLog] = []
        self.frames_since_init = 0
        self.lost_frames = 0
        # place recognition
        self.voc: voc_mod.Vocabulary | None = None
        self._preset_voc: voc_mod.Vocabulary | None = None
        self.bow_db: kdb.BowDatabase | None = None
        self.loop_detector = loop_closing.LoopDetector()
        self.n_loops_closed = 0
        self.n_compactions = 0
        self.compactions: list[tuple[int, int]] = []  # (frame, live keyframes after) per compaction
        self._pending_loop: dict | None = None   # the last insertion's loop candidates
        # Loop-recall hook (synthetic ground truth only): a callable
        # (frame_id_query, frame_id_old) -> bool, "the frusta overlap"
        # (loop_eval.circuit_gt_overlap). When set, every loop-detection round
        # appends to loop_events whether a revisit opportunity existed (an old
        # keyframe with no covisibility to the query whose frustum overlaps
        # it) and whether a loop closed.
        self.loop_gt_overlap = None
        self.loop_events: list[dict] = []
        # Probe mode (loop_probe_floor > 0): one record per round and per
        # verified candidate, with the reference's keys.
        self.loop_gate_events: list[dict] = []
        # Per-frame key of the tracking step, advanced on the device.
        self._key = torch.zeros(2, dtype=torch.int64, device=self.device)
        self.track_view = tv.empty_view(cfg.view_size, cfg.max_points, self.device)
        self.time_log = TimeLog()
        self._build_device_constants()

    def _build_device_constants(self) -> None:
        """Build now the device constants that tracking, GF selection and
        keyframe insertion cache on first use, so that the first such frame
        of a process reads the host no more often than the later ones (each
        host→device copy synchronises). Keyed as the per-frame path keys
        them: by a tensor's device, with positional arguments."""
        dev, h, w = self._key.device, self.cam.height, self.cam.width
        for c in (self.init_orb_cfg, self.orb_cfg):
            orb._level_layout(h, w, c, dev)
        level_consts(self.cfg.scale, self.cfg.n_levels, dev)
        initializer.camera_K(self.cam, dev)
        initializer.camera_K_inv(self.cam, dev)
        quat.dqbar_by_dq(torch.float32, dev)

    def _empty_map(self) -> ms.MapState:
        return ms.empty_map(
            max_keyframes=self.cfg.max_keyframes, max_points=self.cfg.max_points,
            max_kps=2 * self.cfg.n_features, device=self.device,
        )

    # ------------------------------------------------------------------
    def set_vocabulary(self, voc: voc_mod.Vocabulary):
        """Use a pretrained vocabulary (main.cc loads ORBvoc at startup)
        instead of one trained on the first keyframes; it survives reset().
        Keyframes already in the map are registered with it (the reference
        starts an empty database and forgets them)."""
        self.voc = self._preset_voc = voc.to(self.device)
        self.bow_db = self._register_all(self.voc)

    def _register_all(self, voc) -> kdb.BowDatabase:
        """A database holding every valid keyframe of the map."""
        m = self.map
        db = kdb.empty_db(m.kf_capacity, m.kp_capacity, voc.n_words, device=self.device)
        for k in np.flatnonzero(m.kf_valid.cpu().numpy()):
            db = kdb.add_keyframe(db, voc, int(k), m.kf_kp_desc[int(k)], m.kf_kp_valid[int(k)])
        return db

    def load_map_state(self, m: ms.MapState, voc=None, db=None):
        """Resume from a saved map (io_utils/snapshot.py): the system starts
        LOST and relocalizes against it. Its capacities must match this
        configuration. Without a database, the map's keyframes are
        registered with the vocabulary (given, preset or trained)."""
        if m.kp_capacity != self.map.kp_capacity:
            raise ValueError(
                f"snapshot keypoint capacity {m.kp_capacity} != configured {self.map.kp_capacity} "
                "(2*n_features) — load with the same config")
        self.map = ms.MapState(*(t.to(self.device) for t in m))
        self.n_kf = int(self.map.kf_valid.sum())
        if voc is not None:
            self.voc = self._preset_voc = voc.to(self.device)
        if db is not None:
            self.bow_db = kdb.BowDatabase(*(t.to(self.device) for t in db))
        elif self.voc is not None:
            self.bow_db = self._register_all(self.voc)
        self.state = State.LOST
        self.lost_frames = 0

    # ------------------------------------------------------------------
    def process(self, img, timestamp: float) -> FrameLog:
        """Track one (H, W) image (numpy or tensor, any device) taken at
        `timestamp` seconds."""
        img = torch.as_tensor(img).to(device=self.device, dtype=torch.float32)
        cfg_now = (
            self.init_orb_cfg
            if self.state in (State.NO_IMAGES_YET, State.NOT_INITIALIZED, State.INITIALIZING)
            else self.orb_cfg
        )
        self.time_log.start_frame(timestamp)
        log = FrameLog(timestamp=timestamp, state=self.state.name, pose_cw=None, n_inliers=0)

        if self.state == State.WORKING:
            self._track(img, timestamp, log)  # extraction runs inside the tracking step
        else:
            self.time_log.begin("extraction")
            frame = frame_mod.make_frame(img, self.cam, cfg_now)
            self.time_log.end()
            if self.state in (State.NO_IMAGES_YET, State.NOT_INITIALIZED):
                self._first_initialization(frame, timestamp)
            elif self.state == State.INITIALIZING:
                self._initialize(frame, timestamp)
            elif self.state == State.LOST:
                self._relocalize(frame, timestamp, log)

        log.state = self.state.name
        self.frame_id += 1
        self.time_log.end_frame(lmk_inlier=log.n_inliers)
        log.timing_ms = dict(self.time_log.frames[-1].stages_ms)
        self.logs.append(log)
        return log

    # ------------------------------------------------------------------
    def _first_initialization(self, frame, timestamp):
        """Tracking::FirstInitialization."""
        if int(frame.valid.sum()) > 100:
            self.init_frame = frame
            self.init_ts = timestamp
            self.state = State.INITIALIZING

    def _initialize(self, frame, timestamp):
        """Tracking::Initialize + CreateInitialMap."""
        if int(frame.valid.sum()) <= 100:
            self.state = State.NOT_INITIALIZED
            return
        f0 = self.init_frame
        mask = matching.window_mask(f0.uv, frame.uv, 100.0, f0.valid, frame.valid)
        # level-0 only, as SearchForInitialization
        lvl0 = (f0.octave == 0)[:, None] & (frame.octave == 0)[None, :]
        res = matching.match(
            f0.desc, frame.desc, mask & lvl0, max_dist=matching.TH_LOW, ratio=0.9,
            angle_q=f0.angle, angle_t=frame.angle, mutual=True,
        )
        if int(res.matched.sum()) < self.cfg.min_init_matches:
            self.state = State.NOT_INITIALIZED
            return

        idx = res.idx.long()
        uv2 = frame.uv[idx]
        samples = initializer.sample_hypotheses(res.matched, 200, self.generator)
        two = initializer.initialize_two_view(self.cam, f0.uv, uv2, res.matched, samples)
        if not bool(two.success):
            return  # keep trying against the same init frame

        # --- initial map: 2 keyframes + triangulated points, scaled so the
        # median depth is 1 (CreateInitialMap's ComputeSceneMedianDepth;
        # numpy's median, as the reference takes it) ---
        tri = two.is_triangulated
        med_depth = float(np.median(two.points3d.cpu().numpy()[tri.cpu().numpy()][:, 2]))
        X = two.points3d / med_depth
        pose1 = se3.identity_pose(device=self.device)
        pose2 = se3.make_pose(se3.pose_q(two.pose21), se3.pose_t(two.pose21) / med_depth)

        N = frame.capacity
        dev = self.device
        slots = torch.arange(N, dtype=torch.int32, device=dev)  # first N point slots
        obs0 = torch.where(tri, slots, ms.NO_POINT)
        obs1 = ms.set_drop(torch.full((N,), ms.NO_POINT, dtype=torch.int32, device=dev),
                           torch.where(tri, idx, N), slots)
        m = ms.add_points(
            self.map, slots, X, f0.desc, torch.zeros((N, 3), device=dev),
            torch.full((N,), 0.05, device=dev), torch.full((N,), 100.0, device=dev),
            first_kf=0, first_frame=self.frame_id, use=tri,
        )
        m, _ = ms.add_keyframe(m, pose1, self.frame_id - 1, self.init_ts,
                               f0.uv, f0.octave, f0.angle, f0.desc, f0.valid, obs0)
        m, _ = ms.add_keyframe(m, pose2, self.frame_id, timestamp,
                               frame.uv, frame.octave, frame.angle, frame.desc, frame.valid, obs1)

        # Global BA on the two initial views.
        m = self._run_local_ba(m, [0, 1], fixed_ids=[0], iters=(8, 12))
        m = ms.refresh_point_stats(m, scale=self.cfg.scale, n_levels=self.cfg.n_levels)
        if self.cfg.init_min_points > 0:
            # Post-init quality gate: observations of the second keyframe
            # that survived the initial BA.
            if int((m.kf_obs_point[1] >= 0).sum()) < self.cfg.init_min_points:
                self.state = State.NOT_INITIALIZED  # retry from a later frame
                return
        self.map = m

        self.track_view = tv.compute_track_view(m, 1, view_size=self.cfg.view_size)
        self.last_pose = m.kf_pose[1]
        self.last_obs = m.kf_obs_point[1]
        self.last_frame = frame
        self.last_ts = timestamp
        self.velocity = se3.identity_pose(device=dev)
        self.n_ref_tracked = int((m.kf_obs_point[1] >= 0).sum())
        self.n_kf = 2
        self.last_kf_frame = self.frame_id
        self.frames_since_init = 0
        self.state = State.WORKING
        self.trajectory.append((timestamp, self.last_pose.cpu().numpy()))

    # ------------------------------------------------------------------
    def _track(self, img, timestamp, log):
        """WORKING-state frame: the fused tracking step, then its scalars."""
        cfg = self.cfg
        dt = max(timestamp - self.last_ts, 1e-6)
        use_gf = cfg.use_gf and self.frames_since_init > cfg.gf_warmup_frames
        # Only the lazier, auto and random modes draw (on the device).
        noise = tracking.sample_gf_noise(cfg.gf_mode, self.track_view.capacity, cfg.gf_budget, cfg.gf_batch,
                                         self.generator) if use_gf else None

        self.time_log.begin("local_map_track")
        res = tracking.track_frame_fused(
            self.cam, self.orb_cfg, self.map, self.track_view, img,
            self.last_pose, self.last_obs, self.last_frame.uv,
            self.velocity if cfg.use_motion_model else se3.identity_pose(device=self.device),
            torch.full((), dt, dtype=torch.float32, device=self.device), self._key,
            scale=cfg.scale, n_levels=cfg.n_levels,
            gf_budget=cfg.gf_budget, use_gf=use_gf, gf_mode=cfg.gf_mode, gf_batch=cfg.gf_batch, gf_noise=noise,
        )
        frame_now = frame_mod.FrameData(
            # The step returns undistorted coordinates only; raw ones are
            # not needed past this point.
            uv=res.frame_uv, uv_raw=res.frame_uv, octave=res.frame_octave,
            angle=res.frame_angle, desc=res.frame_desc,
            response=torch.zeros_like(res.frame_angle), valid=res.frame_valid,
        )
        self._key = res.next_key
        self.map = self.map._replace(pt_visible=res.pt_visible, pt_found=res.pt_found)
        self.velocity = res.velocity
        self.last_pose = res.pose
        self.last_obs = res.obs_point
        self.last_frame = frame_now
        self.last_ts = timestamp
        self.frames_since_init += 1
        self.time_log.end("local_map_track")
        # The last insertion's loop check, where the reference's synchronous
        # run finalizes it: after this frame's step, before its result.
        self._close_pending_loop()

        # The frame's one read: ok, n_inliers, pose and n_total in one copy
        # (the counts are exact in float32).
        self.time_log.begin("pipeline_wait")
        packed = torch.cat([
            res.ok.to(torch.float32)[None], res.n_inliers.to(torch.float32)[None],
            res.pose, res.n_total.to(torch.float32)[None],
        ]).cpu().numpy()
        self.time_log.end("pipeline_wait")
        ok, n_inliers, pose_np, n_total = bool(packed[0]), int(packed[1]), packed[2:9], int(packed[9])
        if not ok:
            if self.n_kf <= 5:
                # Reset the whole map when lost early (Tracking.cc:719-726).
                self.reset()
            else:
                self.state = State.LOST
                self.last_frame = frame_now  # relocalization can reuse this extraction
            return

        log.pose_cw = pose_np
        log.n_inliers = n_inliers
        self.trajectory.append((timestamp, pose_np))

        # NeedNewKeyFrame on the full tracked density (LM inliers + deferred
        # matches) against the same statistic at the last insertion.
        if tracking.need_new_keyframe(
            n_total, self.n_ref_tracked,
            self.frame_id - self.last_kf_frame,
            self.frame_id - self.last_reloc_frame if self.last_reloc_frame > 0 else 10**9,
            cfg.max_frames_between_kf,
        ):
            if self.n_kf >= cfg.max_keyframes - 2:
                # Keyframe ids are slab slots: only compaction frees culled ones.
                self._compact_keyframes()
            if self.n_kf < cfg.max_keyframes - 1:
                self.time_log.begin("keyframe_insert")
                self._insert_keyframe(frame_now, res.pose, res.obs_point, timestamp)
                self.time_log.end("keyframe_insert")

    def reset(self):
        """Full reset (Tracking::Reset): clear the map and the BoW state and
        return to NOT_INITIALIZED (a preset vocabulary stays). The
        trajectory so far is kept for evaluation."""
        self.map = self._empty_map()
        self.state = State.NOT_INITIALIZED
        self.n_kf = 0
        self.n_ref_tracked = 0
        self.velocity = None
        self.init_frame = None
        self.last_obs = None
        self.bow_db = None
        self.voc = None
        self.loop_detector.reset()
        self._pending_loop = None
        if self._preset_voc is not None:
            self.set_vocabulary(self._preset_voc)
        self.lost_frames = 0
        self.track_view = tv.empty_view(self.cfg.view_size, self.cfg.max_points, self.device)

    def flush(self):
        """Run the loop check the last insertion left; call at sequence end
        before reading results."""
        self._close_pending_loop()

    def _compact_keyframes(self):
        """Renumber live keyframes to the front, the BoW database with them,
        and forget the id-keyed loop state."""
        self._close_pending_loop()
        self.n_compactions += 1
        m2, perm, n_valid = ms.compact_keyframes(self.map)
        self.map = m2
        if self.bow_db is not None:
            self.bow_db = kdb.permute(self.bow_db, perm)
        self.loop_detector.reset()
        self.n_kf = int(n_valid)  # the compaction's one host read
        self.compactions.append((self.frame_id, self.n_kf))
        if self.n_kf > 0:
            self.track_view = tv.compute_track_view(self.map, self.n_kf - 1, view_size=self.cfg.view_size)

    # ------------------------------------------------------------------
    def _relocalize(self, frame, timestamp, log):
        """Tracking::Relocalisation: BoW candidates, their BoW-gated matches,
        PnP RANSAC and local-map tracking in one call, then one read."""
        self._close_pending_loop()
        self.lost_frames += 1
        cfg = self.cfg
        if not (cfg.enable_relocalization and self.voc is not None and self.lost_frames <= cfg.max_lost_frames):
            return
        m = self.map
        words, _ = voc_mod.quantize(self.voc, frame.desc, frame.valid)
        cand, ok = kdb.detect_reloc_candidates(self.bow_db, ms.covisibility(m), voc_mod.bow_vector(self.voc, words),
                                               max_candidates=4)
        res, reloc_view = tracking.relocalize_fused(
            self.cam, m, self.bow_db.words, frame, words, cand, ok, self.generator,
            scale=cfg.scale, n_levels=cfg.n_levels, view_size=cfg.view_size,
        )
        packed = torch.cat([res.ok.to(torch.float32)[None], res.n_inliers.to(torch.float32)[None],
                            res.pose]).cpu().numpy()
        if not packed[0]:
            return
        pose_np = packed[2:9]
        self.track_view = reloc_view
        self.state = State.WORKING
        self.lost_frames = 0
        self.last_reloc_frame = self.frame_id
        self.velocity = se3.identity_pose(device=self.device)
        self.last_pose = res.pose
        self.last_obs = res.obs_point
        self.last_frame = frame
        self.last_ts = timestamp
        log.pose_cw = pose_np
        log.n_inliers = int(packed[1])
        self.trajectory.append((timestamp, pose_np))

    # ------------------------------------------------------------------
    def _maybe_train_vocabulary(self):
        """Without a preset vocabulary, train one on the keyframes' valid
        descriptors once vocab_train_kfs keyframes exist, and register them."""
        if self.voc is not None or self.n_kf < self.cfg.vocab_train_kfs:
            return
        m = self.map
        kf_ids = np.flatnonzero(m.kf_valid.cpu().numpy())
        desc, valid = m.kf_kp_desc.cpu().numpy(), m.kf_kp_valid.cpu().numpy()
        corpus = np.concatenate([desc[k][valid[k]] for k in kf_ids], axis=0)
        self.voc = voc_mod.train_vocabulary(corpus, k=self.cfg.vocab_k, L=self.cfg.vocab_L, device=self.device)
        self.bow_db = self._register_all(self.voc)

    # ------------------------------------------------------------------
    def _close_pending_loop(self):
        if self._pending_loop is not None:
            pending, self._pending_loop = self._pending_loop, None
            self.time_log.begin("loop_closing")
            self._try_close_loop(pending)
            self.time_log.end("loop_closing")

    def _try_close_loop(self, p: dict) -> bool:
        """DetectLoop's consistency check on the host, then ComputeSim3 and
        CorrectLoop for the first consistent candidate that verifies (in
        probe mode, every candidate from streak 2 is verified and recorded)."""
        cfg = self.cfg
        kf_int = p["kf"]
        cand_np = p["cand"]
        ok_np = p["ok"] & (cand_np < kf_int - cfg.loop_min_kf_gap)  # not against recent keyframes
        row_by_cand = {int(c): p["covis_c"][i] for i, c in enumerate(cand_np)}
        event = None
        if self.loop_gt_overlap is not None:
            event = self._loop_event(kf_int, p)
            self.loop_events.append(event)
        pairs = self.loop_detector.update_streaks(
            cand_np, ok_np, lambda c: np.flatnonzero(row_by_cand[int(c)] > 15).tolist())
        th = self.loop_detector.consistency_threshold
        probe = cfg.loop_probe_floor
        if probe > 0:
            self.loop_gate_events.append({"round": True, "kf": kf_int, "n_bow_eligible": int(ok_np.sum()),
                                          "n_consistent": sum(1 for _, s in pairs if s >= th)})
        m = self.map
        for c, streak in pairs:
            if streak < (2 if probe > 0 else th):
                continue
            lm = loop_closing.verify_candidate(self.cam, m, self.bow_db, kf_int, c, self.generator,
                                               scale=cfg.scale, n_levels=cfg.n_levels,
                                               ransac_floor=probe if probe > 0 else 20)
            if probe > 0:
                ok = self._gate_record(kf_int, c, streak, lm, p) and streak >= th
            else:
                ok = bool(lm.ok)
            if not ok:
                continue
            k1 = ms.kf_index(kf_int, self.device)
            old_q_pose = m.kf_pose.index_select(0, k1)[0]
            self.map = loop_closing.correct_loop(m, kf_int, c, lm.S12, p["covis"], cam=self.cam,
                                                 scale=cfg.scale, n_levels=cfg.n_levels)
            # The tracker's pose moves into the corrected gauge through the
            # query keyframe (LoopClosing.cc:429-470); velocity is relative.
            if self.last_pose is not None:
                rel = se3.compose(self.last_pose, se3.inverse(old_q_pose))
                self.last_pose = se3.compose(rel, self.map.kf_pose.index_select(0, k1)[0])
            self.n_loops_closed += 1
            self.loop_detector.reset()
            self.track_view = tv.compute_track_view(self.map, kf_int, view_size=cfg.view_size)
            if event is not None:
                event["closed"] = True
                event["matched_kf"] = int(c)
            return True
        return False

    def _loop_event(self, kf_int: int, p: dict) -> dict:
        """The recall event of a round: whether an old keyframe (before the
        temporal gap) with no covisibility to the query views the same
        ground-truth region. Reads only what the insertion's copy carried."""
        fid, covq = p["kf_frame_id"], p["covis_q"]
        q_fid = int(fid[kf_int])
        opp = any(covq[k] <= 0 and self.loop_gt_overlap(q_fid, int(fid[k]))
                  for k in np.flatnonzero(p["kf_valid"]) if k < kf_int - self.cfg.loop_min_kf_gap)
        return {"kf": kf_int, "frame": q_fid, "opportunity": bool(opp), "closed": False, "matched_kf": None}

    def _gate_record(self, kf_int: int, c: int, streak: int, lm, p: dict) -> bool:
        """Probe mode: one copy of the candidate's ok and funnel counts into
        loop_gate_events; returns ok."""
        ok, nb, nr, ng, no = (int(v) for v in torch.stack(
            [lm.ok.to(torch.int32), lm.n_bow, lm.n_ransac, lm.n_guided, lm.n_inliers]).cpu().tolist())
        gt = None
        if self.loop_gt_overlap is not None:
            fid = p["kf_frame_id"]
            gt = bool(self.loop_gt_overlap(int(fid[kf_int]), int(fid[c])))
        self.loop_gate_events.append({
            "kf": kf_int, "cand": int(c), "streak": streak, "n_bow": nb, "n_ransac": nr, "n_guided": ng,
            "n_opt": no, "accepted": bool(ok) and streak >= self.loop_detector.consistency_threshold,
            "gt_true": gt,
        })
        return bool(ok)

    # ------------------------------------------------------------------
    def insertion_args(self, frame, pose, obs_point, frame_id, timestamp) -> tuple[tuple, dict]:
        """(args, kwargs) of local_mapping.insert_keyframe_fused that insert
        `frame` into the current map in this configuration: the frame's
        keypoints padded to the map's keypoint capacity."""
        cfg = self.cfg
        pad = self.map.kp_capacity - frame.capacity

        def pz(a, fill=0):
            return a if pad == 0 else F.pad(a, [0, 0] * (a.dim() - 1) + [0, pad], value=fill)

        args = (self.cam, self.map, pose, frame_id, timestamp, pz(frame.uv), pz(frame.octave), pz(frame.angle),
                pz(frame.desc), pz(frame.valid, False), pz(obs_point, ms.NO_POINT))
        kwargs = dict(scale=cfg.scale, n_levels=cfg.n_levels, ba_window=cfg.ba_window, ba_fixed=cfg.ba_fixed,
                      n_tri_neighbors=cfg.triangulate_neighbors, ba_points=cfg.ba_points,
                      ba_iters=tuple(cfg.ba_iters), view_size=cfg.view_size)
        return args, kwargs

    def _insert_keyframe(self, frame, pose, obs_point, timestamp):
        """CreateNewKeyFrame + the LocalMapping sequence, one call with no
        host read (pipeline/local_mapping.py), then the BoW registration and
        loop-candidate ranking (no host read either); their results are read
        right after in one copy."""
        cfg = self.cfg
        a, kw = self.insertion_args(frame, pose, obs_point, self.frame_id, timestamp)
        res = local_mapping.insert_keyframe_fused(*a, **kw)
        self.map = res.m
        self.n_kf += 1
        self.last_kf_frame = self.frame_id
        self.track_view = res.view

        self._maybe_train_vocabulary()
        parts = [torch.stack([res.kf_id, res.culled_kf, res.n_ref]).to(torch.int32)]
        do_detect = False
        if self.voc is not None:
            # A keyframe culled by this insertion is tombstoned in the map but
            # still valid in the database: excluded from the ranking here,
            # erased from the database below.
            do_detect = cfg.enable_loop_closing and self.n_kf > cfg.loop_min_kf_gap
            self.bow_db, covis, covis_q, covis_c, cand, ok = kdb.register_and_detect(
                self.bow_db, self.voc, self.map, res.kf_id, res.culled_kf, max_candidates=6, do_detect=do_detect)
            if do_detect:
                parts += [cand, ok.to(torch.int32), covis_c.reshape(-1)]
                if self.loop_gt_overlap is not None:  # the recall event's inputs, in the same copy
                    parts += [covis_q, self.map.kf_frame_id, self.map.kf_valid.to(torch.int32)]
        packed = torch.cat(parts).cpu().numpy()
        kf_id, culled = int(packed[0]), int(packed[1])
        self.n_ref_tracked = int(packed[2])
        if culled >= 0 and self.bow_db is not None:
            self.bow_db = kdb.erase_keyframe(self.bow_db, culled)
        if do_detect:
            C, K = cand.shape[0], self.map.kf_capacity  # candidates' covisibility rows: DetectLoop's groups
            rest = packed[3:]
            e = 2 * C + C * K
            self._pending_loop = {"kf": kf_id, "cand": rest[:C], "ok": rest[C : 2 * C].astype(bool),
                                  "covis_c": rest[2 * C : e].reshape(C, K), "covis": covis}
            if self.loop_gt_overlap is not None:
                q, fid, valid = rest[e:].reshape(3, K)
                self._pending_loop.update(covis_q=q, kf_frame_id=fid, kf_valid=valid.astype(bool))
        return res

    # ------------------------------------------------------------------
    def ba_problem(self, m, kf_ids, fixed_ids, row_active=None):
        """The BA problem over the keyframes `kf_ids` of map m (list order),
        those in `fixed_ids` or not row-active held fixed: their poses, the
        valid points they observe, and every observation weighted 1/σ² of
        its octave. Returns (problem, ids, row-active mask, point mask)."""
        if row_active is None:
            row_active = [True] * len(kf_ids)
        dev = self.device
        P = m.pt_capacity
        ids = torch.tensor(kf_ids, dtype=torch.int64, device=dev)
        act = torch.tensor(row_active, dtype=torch.bool, device=dev)
        obs_point = torch.where(act[:, None], m.kf_obs_point[ids], ms.NO_POINT)
        local_pts = ms.mark(P, torch.where(obs_point >= 0, obs_point, P), dev) & m.pt_valid
        sigma2 = level_consts(self.cfg.scale, self.cfg.n_levels, dev).sigma2[m.kf_kp_octave[ids].long()]
        fixed_mask = torch.tensor([k in fixed_ids or not a for k, a in zip(kf_ids, row_active)],
                                  dtype=torch.bool, device=dev)
        prob = local_ba.BAProblem(
            poses=m.kf_pose[ids], points=m.pt_pos, fixed=fixed_mask, point_valid=local_pts,
            obs_uv=m.kf_kp_uv[ids], obs_point=obs_point,
            obs_w=torch.where(obs_point >= 0, 1.0 / sigma2, 0.0),
        )
        return prob, ids, act, local_pts

    def _run_local_ba(self, m, kf_ids, fixed_ids, iters=(5, 10), row_active=None):
        """BA over the chosen keyframes with the results written back (used
        by the bootstrap; runs once, so its index lists cross to the device
        as they are)."""
        prob, ids, act, local_pts = self.ba_problem(m, kf_ids, fixed_ids, row_active)
        res = local_ba.bundle_adjust(self.cam, prob, iters_stage1=iters[0], iters_stage2=iters[1])
        safe_ids = torch.where(act, ids, m.kf_capacity)
        return m._replace(
            kf_pose=ms.set_drop(m.kf_pose, safe_ids, res.poses),
            pt_pos=torch.where(local_pts[:, None], res.points, m.pt_pos),
            # Drop observations BA classified as outliers (active rows only).
            kf_obs_point=ms.set_drop(m.kf_obs_point, safe_ids, torch.where(res.obs_active, prob.obs_point,
                                                                            ms.NO_POINT)),
        )

    # ------------------------------------------------------------------
    def get_trajectory(self):
        ts = np.asarray([t for t, _ in self.trajectory])
        poses = np.stack([p for _, p in self.trajectory]) if self.trajectory else np.zeros((0, 7))
        return ts, poses
