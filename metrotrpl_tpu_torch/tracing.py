"""Named spans of the port's layers, on the profiler's clock, and a count
of the host's waits for the device inside them.

With no ``torch.profiler`` active, ``span(name)`` is one flag check that
returns a shared context manager doing nothing. Under an active profiler
it opens ``torch.profiler.record_function(name)``, so that the trace
attributes the kernels launched inside to the span, and appends a
:class:`Record`. ``span(name, always=True)``, for coarse set-up steps
only, records with or without a profiler. Spans of one name never nest:
a trace pairs ranges by name and thread.

While a profiler is active every synchronising CUDA call PyTorch makes
(``.item()``, ``.cpu()``, a blocking upload, ``nonzero``) counts against
the innermost open span: the first span under a profiler switches
``torch.cuda.set_sync_debug_mode("warn")`` on and takes that warning off
the ``warnings`` machinery (it is counted, not shown); the first span
after the profiler puts both back. Without CUDA, or before it is
initialised, nothing is counted; calls into the native kernel library
bypass PyTorch and are not seen.

``records()`` gives every record so far, in the order the spans were
entered; ``reset()`` forgets them; at most ``CAP`` are kept and
``dropped()`` counts the rest.
"""

import contextlib
import re
import warnings
from time import perf_counter
from typing import NamedTuple, Optional

import torch
from torch.autograd import profiler as _profiler

#: the most records kept
CAP = 1_000_000

#: the warning ``set_sync_debug_mode("warn")`` gives for each sync
_SYNC_WARNING = "called a synchronizing CUDA operation"


class Record(NamedTuple):
    """One span as it ran."""
    name: str
    parent: int            # index of the innermost span open at entry, -1
    t0: float              # host perf_counter() seconds at entry
    t1: Optional[float]    # ... at exit (None while open)
    syncs: int             # syncs while it was the innermost open span
    traced: bool           # whether a profiler was active at entry


_records = []       # [name, parent, t0, t1, syncs, traced] lists
_open = []          # record index of each open span, innermost last
_dropped = 0
#: while the sync count is on: (sync debug mode, showwarning, filter) to
#: put back
_restore = None


class _Span:
    __slots__ = ("name", "traced", "range")

    def __init__(self, name, traced):
        self.name = name
        self.traced = traced
        self.range = None

    def __enter__(self):
        global _dropped
        if self.traced:
            self.range = torch.profiler.record_function(self.name)
            self.range.__enter__()
        if len(_records) < CAP:
            _open.append(len(_records))
            _records.append([self.name, _open[-2] if len(_open) > 1 else -1,
                             perf_counter(), None, 0, self.traced])
        else:
            _open.append(-1)
            _dropped += 1
        return self

    def __exit__(self, *exc):
        i = _open.pop()
        if i >= 0:
            _records[i][3] = perf_counter()
        if self.range is not None:
            self.range.__exit__(*exc)
        return False


_NO_SPAN = contextlib.nullcontext()


def span(name, always=False):
    """A context manager that records the block as a span named ``name``
    under an active profiler (always, with ``always=True``)."""
    if _profiler._is_profiler_enabled:
        if _restore is None:
            _start_sync_count()
        return _Span(name, True)
    if _restore is not None:
        _stop_sync_count()
    return _Span(name, False) if always else _NO_SPAN


def _on_warning(message, *args, **kwargs):
    if str(message).startswith(_SYNC_WARNING):
        if _open and _open[-1] >= 0:
            _records[_open[-1]][4] += 1
        return
    show = warnings._showwarning_orig if _restore is None else _restore[1]
    show(message, *args, **kwargs)


def _start_sync_count():
    global _restore
    if not torch.cuda.is_initialized():
        return
    warnings.filterwarnings("always", message=re.escape(_SYNC_WARNING))
    _restore = (torch.cuda.get_sync_debug_mode(), warnings.showwarning,
                warnings.filters[0])
    warnings.showwarning = _on_warning
    _set_sync_debug_mode("warn")


def _stop_sync_count():
    global _restore
    mode, show, entry = _restore
    _restore = None
    _set_sync_debug_mode(mode)
    if warnings.showwarning is _on_warning:
        warnings.showwarning = show
    if entry in warnings.filters:
        warnings.filters.remove(entry)
        warnings._filters_mutated()


def _set_sync_debug_mode(mode):
    """Set the mode without the warning that the mode is a prototype."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="Synchronization debug")
        torch.cuda.set_sync_debug_mode(mode)


def records():
    """Every record kept so far, as :class:`Record` tuples."""
    return [Record(*r) for r in _records]


def dropped():
    """Spans not recorded because ``CAP`` records were kept."""
    return _dropped


def reset():
    """Forget every record (spans open now keep running, unrecorded)."""
    global _dropped
    _records.clear()
    _open[:] = [-1] * len(_open)
    _dropped = 0
