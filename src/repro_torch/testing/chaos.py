"""Deterministic fault injection for the campaign runtime.

The chaos harness lets tests (and brave operators) inject failures into
campaign cells *by cell index*, so every recovery path of
:class:`repro_torch.core.runtime.CellRunner` — crash attribution, timeout
kills, transient retries, quarantine — is exercised reproducibly, with
zero flakiness and zero cost when disarmed.

Arming is env-keyed so the injection crosses the ``ProcessPoolExecutor``
boundary for free (workers inherit the parent's environment):

    REPRO_CHAOS="crash@3,flaky@7:2,hang@12,raise@20"

Grammar — comma-separated rules, each ``kind@cell[:attempts]``:

``kind``
    * ``crash`` — kill the worker process via ``os._exit(137)`` (the
      SIGKILL exit code an OOM-killed worker reports).  Surfaces to the
      parent as ``BrokenProcessPool``.  Refuses to run in the main
      process: a campaign without a pool would die outright.
    * ``hang``  — sleep ``$REPRO_CHAOS_HANG`` seconds (default 3600),
      tripping the cell's ``cell_timeout`` deadline.
    * ``raise`` — raise :class:`ChaosError` (a plain ``RuntimeError``):
      classified *deterministic*, never retried.
    * ``flaky`` — raise :class:`TransientChaosError` (an ``OSError``):
      classified *transient*, retried with backoff.

``cell``
    the 0-based cell index in grid order (the position in
    ``CampaignGrid.cells()`` enumeration).

``attempts``
    fire only while the cell's 0-based attempt number is below this
    bound; omitted = fire on every attempt.  ``crash@3:1`` therefore
    means "crash the first attempt of cell 3, let the retry succeed".

The hook sits in ``repro_torch.core.campaign._run_cell`` and costs one
``os.environ.get`` when disarmed; :mod:`repro_torch.testing` is only imported
once a rule string is present.
"""

from __future__ import annotations

import multiprocessing
import os
import re
import time
from typing import Dict, List, NamedTuple, Optional

#: environment variable carrying the rule string
ENV_VAR = "REPRO_CHAOS"
#: environment variable overriding the hang duration (seconds)
ENV_HANG = "REPRO_CHAOS_HANG"

KINDS = ("crash", "hang", "raise", "flaky")

#: exactly the strings ``int()`` accepts in base 10 (Unicode decimal digits,
#: ``_`` between digits, an optional sign, surrounding whitespace)
_INT_LITERAL = re.compile(r"\s*[+-]?\d(?:_?\d)*\s*")


def _int_or_message(raw: str):
    """``(int(raw), None)``, or ``(None, message)`` with the message
    ``int()`` would raise."""
    if _INT_LITERAL.fullmatch(raw) is None:
        return None, f"invalid literal for int() with base 10: {raw!r}"
    return int(raw), None


class ChaosError(RuntimeError):
    """Injected *deterministic* failure — never retried."""


class TransientChaosError(OSError):
    """Injected *transient* failure — retried with backoff."""


class ChaosRule(NamedTuple):
    kind: str                  # one of KINDS
    cell: int                  # 0-based grid-order cell index
    attempts: Optional[int]    # fire while attempt < attempts; None = always

    def fires(self, cell_index: int, attempt: int) -> bool:
        return (cell_index == self.cell
                and (self.attempts is None or attempt < self.attempts))


def parse_chaos(spec: str) -> List[ChaosRule]:
    """Parse a ``kind@cell[:attempts]`` rule string (see module docs)."""
    rules: List[ChaosRule] = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        kind, _, rest = part.partition("@")
        cell_s, _, att_s = rest.partition(":")
        cell, why = _int_or_message(cell_s) if rest else (None,
                                                          "missing '@cell'")
        attempts = None
        if why is None and att_s:
            attempts, why = _int_or_message(att_s)
        if why is not None:
            raise ValueError(
                f"bad {ENV_VAR} rule {part!r} (expected "
                f"'kind@cell[:attempts]', e.g. 'crash@3:1'): {why}")
        if kind not in KINDS:
            raise ValueError(f"bad {ENV_VAR} rule {part!r}: unknown kind "
                             f"{kind!r}; choose from {KINDS}")
        if cell < 0 or (attempts is not None and attempts < 1):
            raise ValueError(f"bad {ENV_VAR} rule {part!r}: cell must be "
                             f">= 0 and attempts >= 1")
        rules.append(ChaosRule(kind, cell, attempts))
    return rules


_cache: Dict[str, List[ChaosRule]] = {}


def chaos_rules() -> List[ChaosRule]:
    """The currently armed rules (parsed once per distinct env value)."""
    spec = os.environ.get(ENV_VAR, "")
    if not spec:
        return []
    if spec not in _cache:
        _cache[spec] = parse_chaos(spec)
    return _cache[spec]


def chaos_hook(cell_index: int, attempt: int) -> None:
    """Fire the first armed rule matching ``(cell_index, attempt)``.

    Called by ``_run_cell`` right before simulating; ``cell_index`` is the
    grid-order index, ``attempt`` the 0-based attempt number."""
    for rule in chaos_rules():
        if not rule.fires(cell_index, attempt):
            continue
        if rule.kind == "crash":
            if multiprocessing.parent_process() is None:
                # no pool to absorb the death — dying here would take the
                # whole campaign (journal included) down un-deterministically
                raise RuntimeError(
                    f"{ENV_VAR} crash@{rule.cell} refused: _run_cell is in "
                    f"the main process (serial path); crash injection needs "
                    f"pool execution (workers > 1 or cell_timeout > 0)")
            os._exit(137)
        if rule.kind == "hang":
            time.sleep(float(os.environ.get(ENV_HANG, "3600")))
            return
        if rule.kind == "raise":
            raise ChaosError(f"injected deterministic failure at cell "
                             f"{cell_index} (attempt {attempt})")
        if rule.kind == "flaky":
            raise TransientChaosError(
                f"injected transient failure at cell {cell_index} "
                f"(attempt {attempt})")
