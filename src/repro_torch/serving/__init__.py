"""Serving: execution plans over frozen packs, SLO policy, micro-batcher,
the two-tier pack cache and the multi-model frontend.

Mirrors the JAX package's ``serving`` package (less ``sharded``, not
ported yet):

* :mod:`plans` — one :class:`ExecutionPlan` per frozen pack: mode, row
  tile, int8 calibration and the bucket → kernel schedule bindings,
  resolved once.
* :mod:`batcher` — the :class:`MicroBatcher` (queue → power-of-two bucket
  → one launch → scatter) and the virtual-clock :func:`replay` driver.
* :mod:`slo` — latency tiers, typed :class:`Rejected` and the
  :class:`AdmissionController` cost model.
* :mod:`pack_cache` — compressed cold tier (:class:`ColdPack`) under an
  LRU hot tier of resolved plans (:class:`PackCache`).
* :mod:`frontend` — the threaded, asyncio-facing :class:`ServingFrontend`
  over a :class:`ModelRegistry`, with the retry → chain fallback →
  quarantine ladder, recovery from the cold tier, the scrubber and
  ``streams=N`` workers on CUDA streams of their own.
* :mod:`lm` — :class:`LMProgram`, greedy prefill/decode of a frozen 4-bit
  transformer as a servable program, its FFN through per-block plans.

Integrity guards (:class:`GuardedPlan`) and fault injection
(:class:`FaultInjector`) live in ``runtime`` and are re-exported here.
"""
from ..runtime.fault import FaultInjector, InjectedFault      # noqa: F401
from ..runtime.integrity import (GuardedPlan, IntegrityError,  # noqa: F401
                                 IntegrityPolicy, unwrap_chain)
from .plans import (ACT_DTYPES, MODES, ExecutionPlan,        # noqa: F401
                    ServableProgram, adopt_plan, build_plan,
                    calibrate_act_scales, forget_plan, get_plan)
from .slo import (TIERS, AdmissionController, Rejected,       # noqa: F401
                  SLOTier, resolve_tier)
from .batcher import Completion, MicroBatcher, Taken, replay  # noqa: F401
from .pack_cache import (CachedPlan, ColdPack, PackCache,     # noqa: F401
                         compress_pack, decode_pack,
                         plan_resident_bytes, verify_cold_pack)
from .frontend import (ModelRegistry, RetryPolicy, Served,    # noqa: F401
                       ServingFrontend)
from .lm import LMProgram, build_lm_program, freeze_lm      # noqa: F401
