"""One validated configuration object for the whole serving stack.

The port's copy of ``repro.serving.config``.  ``ServingConfig`` collapses
the wiring (a latency profile "profiled" with noise, the fitted Eq. 3/4
estimator, the memory estimator, ``make_strategy``, the core) into one
dataclass with validation of strategy × kv_layout × predictor × backend
combinations, ``from_cli()`` / ``from_dict()`` constructors, and
``build_*`` methods that hand back a ready
:class:`~repro_torch.serving.server.SliceServer`.

    server = ServingConfig(strategy="scls", workers=4).build_sim()
    server = ServingConfig.from_cli().build_sim()        # launchers
    server = cfg.build_real(engines, sched_est, mem)     # real engines

Beyond the reference's fields it has one, ``device``: where the real
engines and the proxy predictor's MLP run (``None``: the CUDA card, an
error without one).  ``http_port`` / ``http_host`` are read by the
launcher, which fronts the server with
:class:`~repro_torch.serving.http.HTTPFrontend`.
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np

from repro_torch import DeviceLike

from repro_torch.core.estimator import (ServingTimeEstimator,
                                  a100_llama13b_hf_profile,
                                  a100_llama13b_profile)
from repro_torch.core.memory import (A100_80GB_AVAILABLE, AnalyticMemoryEstimator,
                               LLAMA2_13B_DELTA, MemoryEstimator,
                               PagedMemoryEstimator, RuleBasedMemoryEstimator)
from repro_torch.core.schedulers import ALL_STRATEGIES, StrategyConfig, make_strategy
from repro_torch.obs import Observability
from repro_torch.predict import PREDICTORS, LengthPredictor, make_predictor
from repro_torch.serving.backends import RealBackend, SimBackend
from repro_torch.serving.core import CONTINUOUS_MODES, SchedulerCore
from repro_torch.serving.server import SliceServer

#: strategies a RealBackend can drive (no continuous modes on StaticEngine)
SERVABLE_REAL = tuple(
    s for s in ALL_STRATEGIES
    if make_strategy(s).mode not in CONTINUOUS_MODES)

_PRED_STRATEGIES = ("scls-pred", "oracle")


@dataclasses.dataclass
class ServingConfig:
    """Everything needed to stand up a serving stack, in one place."""

    # --- scheduling ---
    strategy: str = "scls"
    backend: str = "sim"                 # "sim" | "real"
    workers: int = 2
    slice_len: int = 128
    max_gen: int = 1024
    fixed_batch_size: int = 12
    gamma: float = 3.0                   # Γ: minimal schedule interval (s)
    lam: float = 0.5                     # λ in Eq. 12
    max_parallel: int = 12               # ILS conservative cap
    ils_span: int = 32
    # --- KV layout (repro_torch.kvcache) ---
    kv_layout: str = "dense"             # "dense" | "paged"
    page_tokens: int = 16
    # Algorithm-1 no-OOM bound (core.batcher.PACKING_MODES): the default
    # "batch-max" is the paper's closed form (and what the golden batch
    # compositions pin); "envelope" charges each member its own
    # blocks_for(L_j + S) — strictly tighter packing on mixed-length
    # batches, needs kv_layout="paged"
    packing: str = "batch-max"           # "batch-max" | "envelope"
    # envelope lifetime on the paged real backend: "slice" reserves and
    # releases per slice (re-prefill every reschedule, §3.3); "request"
    # keeps prefix pages resident in the engines across slices so a
    # resumed slice re-prefills nothing (persistent StaticEngine storage)
    kv_retain: str = "slice"             # "slice" | "request"
    # cross-request COW prefix sharing: on the paged real backend a new
    # request whose token prefix matches another resident's pages joins
    # them refcounted (``PageAllocator.share``) instead of prefilling.
    # No-op on dense layouts and the sim backend; disable to pin the
    # sharing-free baseline.
    prefix_sharing: bool = True
    # --- generation-length prediction (repro_torch.predict) ---
    predictor: Optional[str] = None      # scls-pred/oracle only
    coverage: float = 0.7
    bucket_phi: float = 2.0
    # --- sim backend ---
    noise_sigma: float = 0.0
    seed: int = 0
    # --- real backend model/memory knobs ---
    arch: str = "llama3.2-1b"
    reduced: bool = True
    m_available: float = 256e6
    zeta: float = 0.9
    mem_bucket: int = 8
    # --- workload knobs consumed by launchers (trace replay) ---
    rate: float = 2.0
    duration: float = 15.0
    # --- online front end (repro_torch.serving.{aio,http,admission}) ---
    http_port: Optional[int] = None      # None = no HTTP endpoint
    http_host: str = "127.0.0.1"         # bind host (fleet: several
                                         # instances + router on one box)
    slo_ms: Optional[float] = None       # default per-request SLO (admission)
    time_scale: Optional[float] = None   # sim pacing: virtual s per wall s
    # --- observability (repro_torch.obs) ---
    # built servers always get a metrics registry (GET /metrics) and a
    # decision-audit ring (GET /debug/decisions); Chrome tracing turns on
    # when a --trace-out path is given (launchers export it on shutdown)
    trace_out: Optional[str] = None      # Perfetto-loadable trace.json path
    audit_capacity: int = 4096           # decision ring size (0 = no audit)
    # --- the port's placement (repro_torch.resolve_device) ---
    # the real engines' and the proxy predictor's device; None = the CUDA
    # card (an error without one), "cpu" runs the kernels' plain versions
    device: DeviceLike = None

    def __post_init__(self) -> None:
        self.validate()

    # ------------------------------------------------------------------
    def validate(self) -> None:
        """Reject invalid strategy × kv_layout × predictor × backend combos
        with actionable messages (called from ``__post_init__``)."""
        if self.strategy not in ALL_STRATEGIES:
            raise ValueError(f"unknown strategy {self.strategy!r}; "
                             f"choose from {ALL_STRATEGIES}")
        if self.backend not in ("sim", "real"):
            raise ValueError(f"unknown backend {self.backend!r} "
                             f"(expected 'sim' or 'real')")
        if self.kv_layout not in ("dense", "paged"):
            raise ValueError(f"unknown kv_layout {self.kv_layout!r} "
                             f"(expected 'dense' or 'paged')")
        if self.predictor is not None:
            if self.predictor not in PREDICTORS:
                raise ValueError(f"unknown predictor {self.predictor!r}; "
                                 f"choose from {tuple(PREDICTORS)}")
            if self.strategy not in _PRED_STRATEGIES:
                raise ValueError(
                    f"predictor={self.predictor!r} needs a prediction-aware "
                    f"strategy ({', '.join(_PRED_STRATEGIES)}); "
                    f"got {self.strategy!r}")
        if self.strategy == "oracle" and self.predictor not in (None, "perfect"):
            raise ValueError(
                "oracle is by definition scls-pred with the perfect "
                f"predictor; predictor={self.predictor!r} contradicts it "
                "(use strategy='scls-pred' for imperfect predictors)")
        if self.backend == "real" and self.strategy not in SERVABLE_REAL:
            raise ValueError(
                f"strategy {self.strategy!r} runs continuous batching, "
                f"which the real backend does not drive (use backend='sim' "
                f"or one of {SERVABLE_REAL})")
        if not 0.0 < self.coverage < 1.0:
            raise ValueError(f"coverage must be in (0, 1), got {self.coverage}")
        if self.workers <= 0:
            raise ValueError(f"need at least one worker, got {self.workers}")
        if self.slice_len <= 0 or self.max_gen <= 0:
            raise ValueError("slice_len and max_gen must be positive")
        # --page-tokens is the block-rounding unit of the whole paged
        # subsystem (core.memory.blocks_for); a non-integer or < 1 value
        # only surfaced later as an opaque shape/indexing failure deep in
        # the allocator or kernels — reject it here with the fix spelled
        # out instead
        if isinstance(self.page_tokens, bool) \
                or not isinstance(self.page_tokens, int):
            raise ValueError(f"page_tokens must be an integer number of "
                             f"cache slots per KV block, got "
                             f"{self.page_tokens!r}")
        if self.page_tokens < 1:
            raise ValueError(f"page_tokens must be >= 1, "
                             f"got {self.page_tokens}")
        if self.kv_retain not in ("slice", "request"):
            raise ValueError(f"unknown kv_retain {self.kv_retain!r} "
                             f"(expected 'slice' or 'request')")
        if self.packing not in ("batch-max", "envelope"):
            raise ValueError(f"unknown packing {self.packing!r} "
                             f"(expected 'batch-max' or 'envelope')")
        if self.packing == "envelope" and self.kv_layout != "paged":
            raise ValueError(
                "packing='envelope' charges per-request block envelopes, "
                "which only a paged block pool can account exactly; use "
                "kv_layout='paged' (--kv-layout paged) or the default "
                "batch-max bound")
        if self.kv_retain == "request":
            if self.kv_layout != "paged":
                raise ValueError(
                    "kv_retain='request' keeps prefix pages resident in "
                    "the engines, which needs kv_layout='paged'")
            if self.backend != "real":
                raise ValueError(
                    "kv_retain='request' is an engine-storage policy; the "
                    "sim backend has no engine storage (use backend='real')")
        if self.bucket_phi <= 1.0:
            raise ValueError(f"bucket_phi must be > 1, got {self.bucket_phi}")
        if self.http_port is not None and not 0 <= self.http_port <= 65535:
            raise ValueError(f"http_port must be in [0, 65535] (0 = "
                             f"ephemeral), got {self.http_port}")
        if not isinstance(self.http_host, str) or not self.http_host.strip():
            raise ValueError(f"http_host must be a non-empty bind host, "
                             f"got {self.http_host!r}")
        if self.slo_ms is not None and self.slo_ms <= 0:
            raise ValueError(f"slo_ms must be positive, got {self.slo_ms}")
        if self.time_scale is not None:
            if self.time_scale <= 0:
                raise ValueError(f"time_scale must be positive, "
                                 f"got {self.time_scale}")
            if self.backend != "sim":
                raise ValueError(
                    "time_scale paces virtual time, which only the sim "
                    "backend has; the real backend's engines consume wall "
                    "time already")
        if self.audit_capacity < 0:
            raise ValueError(f"audit_capacity must be >= 0 (0 disables "
                             f"the decision audit), got {self.audit_capacity}")
        if self.trace_out is not None and not str(self.trace_out).strip():
            raise ValueError("trace_out must be a non-empty path "
                             "(or None to disable tracing)")

    # ------------------------------------------------------------------
    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "ServingConfig":
        """Construct from a plain mapping; unknown keys are an error."""
        fields = {f.name for f in dataclasses.fields(cls)}
        unknown = sorted(set(d) - fields)
        if unknown:
            raise ValueError(f"unknown ServingConfig keys: {unknown}")
        return cls(**dict(d))

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def add_cli_args(cls, ap: argparse.ArgumentParser) -> None:
        """Register the shared serving flags on an existing parser."""
        ap.add_argument("--strategy", default=cls.strategy,
                        choices=ALL_STRATEGIES)
        ap.add_argument("--backend", default=cls.backend,
                        choices=["sim", "real"])
        ap.add_argument("--workers", type=int, default=cls.workers)
        ap.add_argument("--slice-len", type=int, default=cls.slice_len)
        ap.add_argument("--max-gen", type=int, default=cls.max_gen)
        ap.add_argument("--fixed-batch-size", type=int,
                        default=cls.fixed_batch_size)
        ap.add_argument("--gamma", type=float, default=cls.gamma)
        ap.add_argument("--max-parallel", type=int, default=cls.max_parallel)
        ap.add_argument("--kv-layout", default=cls.kv_layout,
                        choices=["dense", "paged"],
                        help="worker KV layout (repro_torch.kvcache): paged "
                             "reserves slice envelopes block by block")
        ap.add_argument("--page-tokens", type=int, default=cls.page_tokens,
                        help="cache slots per KV block for --kv-layout paged")
        ap.add_argument("--packing", default=cls.packing,
                        choices=["batch-max", "envelope"],
                        help="Algorithm-1 no-OOM bound: 'batch-max' "
                             "charges every batch member the longest "
                             "member's (L_i + S) envelope (paper default); "
                             "'envelope' charges each member its own "
                             "block envelope — tighter packing, needs "
                             "--kv-layout paged")
        ap.add_argument("--kv-retain", default=cls.kv_retain,
                        choices=["slice", "request"],
                        help="paged real backend: 'slice' releases each "
                             "member's envelope at slice end (re-prefill "
                             "on reschedule); 'request' keeps prefix pages "
                             "resident in the engines so resumed slices "
                             "re-prefill nothing")
        ap.add_argument("--no-prefix-sharing", dest="prefix_sharing",
                        action="store_false", default=cls.prefix_sharing,
                        help="disable COW prefix-page sharing on the paged "
                             "real backend (multi-turn sessions and shared "
                             "prompts then re-prefill their history)")
        ap.add_argument("--predictor", default=None, choices=list(PREDICTORS),
                        help="length predictor for --strategy scls-pred")
        ap.add_argument("--coverage", type=float, default=cls.coverage,
                        help="calibration target quantile for predicted caps")
        ap.add_argument("--noise-sigma", type=float, default=cls.noise_sigma)
        ap.add_argument("--seed", type=int, default=cls.seed)
        ap.add_argument("--arch", default=cls.arch)
        ap.add_argument("--reduced", action="store_true", default=cls.reduced)
        ap.add_argument("--rate", type=float, default=cls.rate)
        ap.add_argument("--duration", type=float, default=cls.duration)
        ap.add_argument("--http-port", type=int, default=cls.http_port,
                        help="serve an OpenAI-compatible HTTP endpoint on "
                             "this port (0 = ephemeral) instead of the "
                             "trace-replay demo")
        ap.add_argument("--http-host", default=cls.http_host,
                        help="bind host for --http-port (default "
                             "127.0.0.1; several instances plus the fleet "
                             "router share one box by port)")
        ap.add_argument("--slo-ms", type=float, default=cls.slo_ms,
                        help="default per-request SLO for admission control "
                             "(requests predicted to miss it get 429)")
        ap.add_argument("--time-scale", type=float, default=cls.time_scale,
                        help="sim-backend pacing: virtual seconds served "
                             "per wall second (1 = real time; default: "
                             "as fast as possible)")
        ap.add_argument("--trace-out", default=cls.trace_out,
                        metavar="TRACE_JSON",
                        help="record a Chrome trace (Perfetto-loadable) of "
                             "the run and write it here on shutdown; the "
                             "decision audit is dumped next to it as "
                             "*.decisions.json")
        ap.add_argument("--audit-capacity", type=int,
                        default=cls.audit_capacity,
                        help="scheduler decision-audit ring size "
                             "(GET /debug/decisions; 0 disables)")
        ap.add_argument("--m-available", type=float,
                        default=cls.m_available,
                        help="KV bytes per worker of the real backend "
                             "(Eq. 5-9; the page pool of --kv-layout paged)")
        ap.add_argument("--device", default=cls.device,
                        help="torch device of the real engines and the "
                             "proxy predictor (default: the CUDA card; "
                             "'cpu' runs the kernels' plain versions)")

    @classmethod
    def from_cli(cls, argv: Optional[Sequence[str]] = None,
                 description: str = "SCLS serving stack",
                 **defaults: Any) -> "ServingConfig":
        """Parse the shared serving flags into a validated config.

        ``defaults`` override the dataclass defaults (launchers pick their
        own demo-scale values) but never a flag the user actually passed.
        """
        ap = argparse.ArgumentParser(description=description)
        cls.add_cli_args(ap)
        if defaults:
            unknown = sorted(set(defaults)
                             - {f.name for f in dataclasses.fields(cls)})
            if unknown:
                raise ValueError(f"unknown ServingConfig defaults: {unknown}")
            ap.set_defaults(**defaults)
        args = vars(ap.parse_args(argv))
        try:
            return cls.from_dict(args)
        except ValueError as e:
            ap.error(str(e))
            raise  # unreachable; keeps type checkers honest

    # ------------------------------------------------------------------
    # build_sim / build_real
    # ------------------------------------------------------------------
    def observability(self) -> Observability:
        """The ``repro_torch.obs`` bundle for built servers: metrics + decision
        audit always (both are cheap and observation-only — the golden
        dispatch logs are asserted bit-exact with them on), Chrome tracing
        only when ``trace_out`` is set."""
        return Observability.standard(trace=self.trace_out is not None,
                                      audit_capacity=self.audit_capacity)

    def length_predictor(self) -> Optional[LengthPredictor]:
        """The predictor of a prediction-aware strategy, built as the
        core's ``PredictionPipeline`` builds it but placed on ``device``
        (the proxy's MLP; histogram and perfect run on the host); ``None``
        for every other strategy."""
        s = self.strategy_config()
        if s.mode != "pred":
            return None
        return make_predictor(s.predictor or "histogram", max_gen=s.max_gen,
                              coverage=s.coverage, device=self.device)

    def strategy_config(self) -> StrategyConfig:
        return make_strategy(self.strategy, slice_len=self.slice_len,
                             max_gen=self.max_gen,
                             fixed_batch_size=self.fixed_batch_size,
                             gamma=self.gamma, lam=self.lam,
                             max_parallel=self.max_parallel,
                             predictor=self.predictor or "histogram",
                             coverage=self.coverage,
                             bucket_phi=self.bucket_phi,
                             kv_layout=self.kv_layout,
                             packing=self.packing)

    def memory_estimator(self, delta_bytes: float,
                         m_available: Optional[float] = None
                         ) -> MemoryEstimator:
        """The memory model matching this config's kv_layout (Eq. 5–9 /
        block pool)."""
        m_ava = self.m_available if m_available is None else m_available
        if self.kv_layout == "paged":
            mem = PagedMemoryEstimator(delta_bytes=delta_bytes,
                                       m_available=m_ava, zeta=self.zeta,
                                       page_tokens=self.page_tokens,
                                       bucket=self.mem_bucket,
                                       kv_retain=self.kv_retain)
            if mem.total_blocks < 1:
                # the downstream failure is an opaque PageAllocator /
                # shape error; name the actual misconfiguration instead
                raise ValueError(
                    f"page_tokens={self.page_tokens} with "
                    f"m_available={m_ava:g} and zeta={self.zeta} yields a "
                    f"zero-block KV pool (block = page_tokens * Δ bytes); "
                    f"lower --page-tokens or raise the memory budget")
            return mem
        return AnalyticMemoryEstimator(delta_bytes=delta_bytes,
                                       m_available=m_ava, zeta=self.zeta,
                                       bucket=self.mem_bucket)

    def build_sim(self, true_lat: Optional[ServingTimeEstimator] = None,
                  sched_est: Optional[ServingTimeEstimator] = None,
                  mem: Optional[MemoryEstimator] = None,
                  engine_profile: str = "ds") -> SliceServer:
        """SliceServer over the discrete-event SimBackend.

        With no estimators given, the full paper testbed is built
        (``default_sim_environment``: A100/LLaMA2-13B profile, fitted
        estimator, DS rule table or HF analytic memory).  Partially
        specified setups stay *self-consistent*: a missing ``sched_est``
        is fitted from the given ``true_lat`` and a missing ``mem``
        defaults to the analytic (or paged) A100 model — never the DS
        rule table, which is only the all-defaults "ds" behavior.
        """
        if true_lat is None and sched_est is None and mem is None:
            true_lat, sched_est, mem = default_sim_environment(
                engine_profile, paged=self.kv_layout == "paged",
                page_tokens=self.page_tokens)
        else:
            if true_lat is None:
                if engine_profile not in _PROFILES:
                    raise ValueError(
                        f"unknown engine profile {engine_profile!r}")
                true_lat = _PROFILES[engine_profile]()
            if sched_est is None:
                sched_est = fitted_estimator(true_lat)
            if mem is None:
                mem = self.memory_estimator(LLAMA2_13B_DELTA,
                                            m_available=A100_80GB_AVAILABLE)
        backend = SimBackend(true_lat, noise_sigma=self.noise_sigma,
                             seed=self.seed)
        core = SchedulerCore(self.strategy_config(), backend, self.workers,
                             sched_est, mem,
                             predictor=self.length_predictor(),
                             ils_span=self.ils_span,
                             obs=self.observability())
        return SliceServer(core, default_slo_ms=self.slo_ms,
                           time_scale=self.time_scale)

    def build_real(self, engines: Sequence[Any],
                   sched_est: ServingTimeEstimator,
                   mem: MemoryEstimator) -> SliceServer:
        """SliceServer over real StaticEngine workers (one per engine)."""
        backend = RealBackend(engines, mem=mem, kv_layout=self.kv_layout,
                              sched_bucket=sched_est.bucket,
                              kv_retain=self.kv_retain)
        core = SchedulerCore(self.strategy_config(), backend, len(engines),
                             sched_est, mem,
                             predictor=self.length_predictor(),
                             ils_span=self.ils_span,
                             obs=self.observability())
        return SliceServer(core, default_slo_ms=self.slo_ms)

    def build(self, **kwargs: Any) -> SliceServer:
        """Dispatch on ``backend`` (build_real needs engines/sched_est/mem)."""
        if self.backend == "real":
            return self.build_real(**kwargs)
        return self.build_sim(**kwargs)


# ---------------------------------------------------------------------------
# the paper-testbed wiring, centralized
# ---------------------------------------------------------------------------
_PROFILES = {"ds": a100_llama13b_profile, "hf": a100_llama13b_hf_profile}


def fitted_estimator(true_lat: ServingTimeEstimator,
                     seed: int = 0) -> ServingTimeEstimator:
    """'Profile' the ground-truth latency model with 2% measurement noise
    and fit Eq. 3/4 — mirrors the paper's one-time profiling step."""
    rng = np.random.default_rng(seed)
    pre = [(N, L, true_lat.t_prefill(N, L) * rng.lognormal(0, 0.02))
           for N in (1, 2, 4, 8, 16, 32) for L in (16, 128, 512, 1024)]
    dec = [(N, L, true_lat.tau_decode(L, N) * rng.lognormal(0, 0.02))
           for N in (1, 2, 4, 8, 16, 32) for L in (16, 128, 512, 1024)]
    est, _, _ = ServingTimeEstimator.fit(pre, dec)
    return est


def default_sim_environment(
        engine_profile: str = "ds", fit_seed: int = 0, paged: bool = False,
        page_tokens: int = 16,
        ) -> Tuple[ServingTimeEstimator, ServingTimeEstimator,
                   MemoryEstimator]:
    """(ground-truth latency, fitted scheduler estimator, memory model)
    for the paper's A100/LLaMA2-13B testbed.

    ``engine_profile``: "ds" (DeepSpeed; Algorithm 2 rule table) or "hf"
    (HuggingFace; Eq. 5–9 analytic model), as in §5.1.
    """
    if engine_profile not in _PROFILES:
        raise ValueError(f"unknown engine profile {engine_profile!r} "
                         f"(expected one of {tuple(_PROFILES)})")
    true_lat = _PROFILES[engine_profile]()
    est = fitted_estimator(true_lat, seed=fit_seed)
    mem: MemoryEstimator
    if paged:
        mem = PagedMemoryEstimator(delta_bytes=LLAMA2_13B_DELTA,
                                   m_available=A100_80GB_AVAILABLE,
                                   zeta=0.9, page_tokens=page_tokens)
    elif engine_profile == "ds":
        mem = RuleBasedMemoryEstimator()
    else:
        mem = AnalyticMemoryEstimator(delta_bytes=LLAMA2_13B_DELTA,
                                      m_available=A100_80GB_AVAILABLE,
                                      zeta=0.9)
    return true_lat, est, mem
