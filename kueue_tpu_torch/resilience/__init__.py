"""Device-fault containment and graceful degradation for the solver's
path on the card: the port of kueue_tpu/resilience.

- faultinject: seedable, scripted fault injection at named sites
  around the device dispatch, the decisions' collect, the arena
  scatter and the solver's journal replay; free when disabled.
- watchdog: per-dispatch deadlines; a collect past its deadline raises
  DispatchTimeout instead of blocking the cycle.
- supervisor: the dispatch runs on a persistent supervised worker
  under the watchdog's cold clamp; a hang is abandoned.
- breaker: a circuit breaker fed by the device faults; N consecutive
  faults pin cycles to the CPU ("cpu-breaker") until a half-open probe
  with exponential backoff and jitter re-admits the device route.
- degrade: the cycle-budget degradation ladder (normal -> shed ->
  survival), off at budget 0.

The JAX package's crash-restart recovery and hot-standby replica are
not ported yet.
"""

from kueue_tpu_torch.resilience.breaker import (  # noqa: F401
    CLOSED,
    HALF_OPEN,
    OPEN,
    CircuitBreaker,
)
from kueue_tpu_torch.resilience.degrade import (  # noqa: F401
    NORMAL,
    SHED,
    SURVIVAL,
    DegradationLadder,
)
from kueue_tpu_torch.resilience.faultinject import (  # noqa: F401
    SITE_APPLY,
    SITE_COLLECT,
    SITE_DISPATCH,
    SITE_REPLAY,
    SITE_SCATTER,
    SITE_STORE,
    SITES,
    DeviceFault,
    FaultInjector,
    InjectedCrash,
    InjectedFault,
)
from kueue_tpu_torch.resilience.supervisor import (  # noqa: F401
    SupervisedTimeout,
    SupervisedWorker,
)
from kueue_tpu_torch.resilience.watchdog import (  # noqa: F401
    DispatchTimeout,
    DispatchWatchdog,
)
