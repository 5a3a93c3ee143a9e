"""Knob hooks: the write-back seam between an online tuner and a live fleet.

The port of ``repro.fleet.knobs`` (pure Python, the same as the
reference).  Every layer so far *observes* the running fleet;
``repro_torch.sched.tuner``
closes the loop and *writes back* into it.  This module is the seam that
makes those writes safe and uniform: a ``Knob`` names one tunable quantity
and enumerates its admissible values (tuners work on the ordered index
grid, so annealed SPSA steps and bandit arms are well defined), and a
``KnobHooks`` registry binds each knob to a setter/getter pair supplied by
whoever owns the state — a mux (tick budget), a serving loop, or a
simulated workload (``repro_torch.fleet.scenarios.TunableScenario``).

Two rules keep write-back as disciplined as the transport layer's
exactly-once ticks:

- **Applies happen between ticks.**  A setter must only mutate state a
  tick reads at its start (``VetMux.tick`` reads ``self.budget`` when it
  plans), never state a tick is mid-way through; callers (the tuner's
  ``step``) apply knobs strictly after one tick's objective sample and
  before the next tick.
- **Every apply is validated and reversible.**  ``apply`` rejects unknown
  knobs and out-of-grid values before touching any setter, and
  ``snapshot`` round-trips through the getters, so a tuner can always
  capture the pre-probe setting and restore it on rollback.
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Callable, Dict, Mapping, MutableMapping, Sequence, Tuple

__all__ = ["Knob", "KnobHooks", "mux_knob_hooks"]

KNOB_KINDS = ("spsa", "bandit")


@dataclasses.dataclass(frozen=True)
class Knob:
    """One tunable quantity: a name plus its ordered admissible values.

    ``kind`` selects the tuner mechanism: ``"spsa"`` knobs are perturbed
    on their value *index* (the grid must be ordered so a +/-1 index step
    is a meaningful nudge — microbatch counts, chunk sizes); ``"bandit"``
    knobs have no useful index geometry (modes, placements, budgets whose
    response is not unimodal) and are explored as discrete arms instead.

    Example::

        >>> k = Knob("q_chunk", (16, 32, 64, 128))
        >>> k.index_of(64), k.value(2), k.clip(9)
        (2, 64, 3)
    """

    name: str
    values: Tuple
    kind: str = "spsa"

    def __post_init__(self):
        object.__setattr__(self, "values", tuple(self.values))
        if not self.values:
            raise ValueError(f"knob {self.name!r} needs at least one value")
        if len(set(self.values)) != len(self.values):
            raise ValueError(f"knob {self.name!r} has duplicate values")
        if self.kind not in KNOB_KINDS:
            raise ValueError(f"knob kind must be one of {KNOB_KINDS}, "
                             f"got {self.kind!r}")

    def index_of(self, value) -> int:
        """Grid index of ``value``; raises ``ValueError`` off-grid."""
        try:
            return self.values.index(value)
        except ValueError:
            raise ValueError(
                f"{value!r} is not an admissible value for knob "
                f"{self.name!r} (grid: {self.values})") from None

    def value(self, index: int):
        return self.values[self.clip(index)]

    def clip(self, index: int) -> int:
        """Clamp an index onto the grid (SPSA probes near the boundary)."""
        return max(0, min(len(self.values) - 1, int(index)))


class KnobHooks:
    """Registry binding knobs to the setters/getters that own their state.

    Example::

        >>> state = {"n_micro": 1}
        >>> hooks = KnobHooks.over_state((Knob("n_micro", (1, 2, 4)),), state)
        >>> hooks.apply({"n_micro": 4}), state["n_micro"]
        ({'n_micro': 4}, 4)
        >>> hooks.snapshot()
        {'n_micro': 4}
    """

    def __init__(self):
        self._knobs: "OrderedDict[str, Knob]" = OrderedDict()
        self._setters: Dict[str, Callable] = {}
        self._getters: Dict[str, Callable] = {}

    def __repr__(self) -> str:
        return f"KnobHooks({', '.join(self._knobs)})"

    def register(self, knob: Knob, setter: Callable, getter: Callable) \
            -> "KnobHooks":
        """Bind one knob; returns ``self`` so registrations chain.

        Raises:
            ValueError: duplicate knob name.
        """
        if knob.name in self._knobs:
            raise ValueError(f"knob {knob.name!r} is already registered")
        self._knobs[knob.name] = knob
        self._setters[knob.name] = setter
        self._getters[knob.name] = getter
        return self

    @classmethod
    def over_state(cls, knobs: Sequence[Knob],
                   state: MutableMapping) -> "KnobHooks":
        """Hooks whose setters/getters are plain dict writes/reads — the
        harness for simulated workloads and for tuner unit tests."""
        hooks = cls()
        for knob in knobs:
            hooks.register(knob,
                           lambda v, _s=state, _n=knob.name: _s.__setitem__(_n, v),
                           lambda _s=state, _n=knob.name: _s[_n])
        return hooks

    @property
    def knobs(self) -> Tuple[Knob, ...]:
        return tuple(self._knobs.values())

    def knob(self, name: str) -> Knob:
        if name not in self._knobs:
            raise KeyError(f"knob {name!r} is not registered "
                           f"(have: {tuple(self._knobs)})")
        return self._knobs[name]

    def __contains__(self, name: str) -> bool:
        return name in self._knobs

    def __len__(self) -> int:
        return len(self._knobs)

    def apply(self, assignment: Mapping) -> Dict:
        """Validate the whole assignment, then write it through the setters.

        Validation is all-or-nothing: an unknown knob or an off-grid value
        raises before *any* setter runs, so a failed apply never leaves the
        fleet half-written.

        Returns:
            The applied ``{name: value}`` dict (a copy).

        Raises:
            KeyError: unknown knob name.
            ValueError: a value outside its knob's grid.
        """
        for name, value in assignment.items():
            self.knob(name).index_of(value)  # validates both name and value
        applied = {}
        for name, value in assignment.items():
            self._setters[name](value)
            applied[name] = value
        return applied

    def snapshot(self) -> Dict:
        """Current value of every registered knob, read via the getters."""
        return {name: self._getters[name]() for name in self._knobs}


def mux_knob_hooks(mux, *, budget_values: Sequence[int] = (8, 16, 32, 64),
                   hooks: KnobHooks = None) -> KnobHooks:
    """Fleet-side hooks for any mux variant (``VetMux`` / ``ShardedVetMux``
    / ``TransportVetMux``): the per-tick window-row ``tick_budget`` knob.

    The budget lives driver-side in every variant (the sharded and
    transport fleets water-fill it across shards at the top of each tick),
    so applying it between ticks is race-free even with worker processes.
    Registered as a bandit knob: the budget's latency/backlog response is
    not unimodal in general, so arms beat index gradients.

    Pass ``hooks=`` to extend an existing registry (e.g. a scenario's
    workload knobs) instead of starting a new one.
    """
    values = tuple(int(v) for v in budget_values)
    if any(v < 1 for v in values):
        raise ValueError(f"tick budgets must be >= 1 row, got {values}")
    hooks = hooks if hooks is not None else KnobHooks()

    def _set(v):
        mux.budget = int(v)

    def _get():
        # A mux built with budget=None reports the grid's largest arm
        # (unbounded behaves like the loosest admissible budget).
        return max(values) if mux.budget is None else int(mux.budget)

    return hooks.register(Knob("tick_budget", values, kind="bandit"),
                          _set, _get)
