"""What the readers of the program's own spans share: the span records
the program keeps (``metrotrpl_tpu_torch.tracing``), read raw, and the
totals, self times and set-up split computed from them here, so that no
change of the program's own code can move the yardstick.

A record is the tuple (name, parent, t0, t1, syncs, traced): the span's
name; the index of the innermost span open when it opened, or -1; the
host's perf_counter seconds at entry and exit (exit None while open);
the synchronising CUDA calls counted while it was the innermost open
span; whether a profiler was active when it opened. A traced record is
one made inside the traced windows or calls, the work that the context's
``iterations`` and ``evaluations`` count.
"""

#: the program's spans that the readers read
ITERATION = "metrotrpl.walk.iteration"
EVAL = "metrotrpl.likelihood.eval"
LADDER_SYNC = "metrotrpl.ladder.sync"
IRF = "metrotrpl.likelihood.irf"
BUILD = "metrotrpl.likelihood.build"


def program_records():
    """Every record the program kept so far, or None where the program
    keeps none or traced none of them."""
    try:
        from metrotrpl_tpu_torch import tracing
    except ImportError:
        return None
    recs = [tuple(r)[:6] for r in tracing.records()]
    return recs if any(r[5] for r in recs) else None


def _own(recs, name):
    """Indices of the closed traced records of ``name``."""
    return [i for i, r in enumerate(recs)
            if r[0] == name and r[5] and r[3] is not None]


def host_s(recs, name):
    """Host seconds inside the traced records of ``name``, or None where
    there are none."""
    own = _own(recs, name)
    return sum(recs[i][3] - recs[i][2] for i in own) if own else None


def self_s(recs, name):
    """Host seconds inside the traced records of ``name`` that none of
    their child records covers, or None where there are none."""
    own = set(_own(recs, name))
    if not own:
        return None
    total = sum(recs[i][3] - recs[i][2] for i in own)
    inner = sum(r[3] - r[2] for r in recs
                if r[1] in own and r[3] is not None)
    return total - inner


def syncs(recs):
    """Synchronising CUDA calls counted inside the traced records."""
    return sum(r[4] for r in recs if r[5])


def setup_s(recs, name):
    """Host seconds of the records of ``name`` that ended before the first
    traced record began: the set-up's share, or None where none did."""
    first = min(r[2] for r in recs if r[5])
    d = [r[3] - r[2] for r in recs
         if r[0] == name and r[3] is not None and r[3] <= first]
    return sum(d) if d else None


def per(value, n, scale=1.0):
    """value x scale per unit of work, or None without either."""
    if value is None or not n:
        return None
    return scale * value / n
