"""Per-(spec, op, shape) launch-geometry autotuner for the CUDA ⊞-MAC.

Launch geometry never changes the kernels' *results*: every output is one
thread that walks its contraction in ascending order, whatever the block
it sits in.  It changes their speed.  The kernels of ``csrc/lns_mac.cu``
read one launch parameter: the tiled ``mac_kernel``'s output rows per
block (one warp a row, 1, 2, 4 or 8 warps a block; 4 by default), which
sets how many warps share a block's staged B tile and Δ-table copy and how
many idle warps a launch of few rows carries.  This module is the one
place that parameter is chosen for every caller that says ``blocks=auto``
(a :class:`~repro_torch.core.spec.NumericsSpec` axis, also per layer
through :class:`~repro_torch.core.plan.NumericsPlan` rules such as
``hidden=blocks:auto``).  Nothing else is tuned: the short form
(``mac_short_kernel``, CT <= ``SHORT_STEPS``), the ⊞-SGD and the ⊞-reduce
each have one fixed geometry, which :func:`candidate_blocks` returns alone
and :func:`lookup` returns without measuring or caching.

Resolution order (:func:`lookup`):

1. in-memory cache;
2. persistent JSON cache under ``.lns_autotune/`` (override with
   ``LNS_AUTOTUNE_DIR``).  One file per environment (the key hashes the
   torch version, the CUDA version and the card's name, or ``"cpu"``), so
   a cache measured on one machine never feeds another; each entry records
   the git commit, the wall time and the search depth it was measured at;
3. a measured search over the shared-memory-pruned candidates
   (:func:`candidate_blocks`), each timed by CUDA events on the card, its
   device time alone (:func:`_measure_ms`), then persisted.

Measurement happens only on the card and outside CUDA graph capture; the
CPU lane runs the plain versions, which read no launch parameter, so a
lookup there returns :func:`heuristic_blocks` (today's 4 rows) and
persists nothing.  Set ``LNS_AUTOTUNE_DISABLE=1`` to force the heuristic
everywhere.

Shape convention: every op is described as ``(R, C, CT)``, output rows,
output columns, contraction steps (per segment for ``dw_partials``), as
the JAX package's autotuner describes them:

====================  =============  =================================
op                    (R, C, CT)     geometry ``(rows, cols, steps)``
====================  =============  =================================
``fwd``               (M, N, K)      tiled: ``(w, 32, 32)``, w rows a
``dx``                (M, K, N)      block, 32 columns, 32 steps staged
``dw``                (K, N, M)      at once; short (CT <= 12): ``(1,
``dw_partials``       (K, N, seg)    128, CT)``, 128 flattened outputs
                                     a block, every step in registers
``boxsum``            (M, 1, K)      ``(b, 1, K)``, one row a thread,
                                     b = min(128, M rounded up to 32)
====================  =============  =================================
"""
from __future__ import annotations

import functools
import hashlib
import json
import os
import subprocess
import time
import warnings

import torch

from ..core.delta import DeltaSpec
from ..core.formats import LNSFormat
from .lns_matmul.lns_matmul import MAC_BLOCK_ROWS as TILED_ROWS
from .lns_matmul.lns_matmul import MAC_TILE_COLS as TILE_COLS

OPS = ("fwd", "dx", "dw", "dw_partials", "boxsum")

#: The tiled form's rows per block unless a caller picks others.
DEFAULT_ROWS = 4
#: ``csrc/lns_mac.cu`` constants (the library reports the last two, which
#: ``chip_smoke.py`` checks): the tiled form's staged steps (``kTileK``),
#: the short form's block (``kShortThreads``), the ⊞-reduce's largest
#: block (``kBoxsumThreads``), the short form's longest contraction
#: (``kShortSteps``) and the Δ table's largest size (``kMaxTab``).
TILE_STEPS = 32
SHORT_STEPS = 12
SHORT_THREADS = 128
BOXSUM_THREADS = 128
MAX_TABLE = 1024

#: Static shared memory a block may hold on an H100 without an opt-in.
DEFAULT_SMEM_BUDGET = 48 * 1024

DEFAULT_CACHE_DIR = ".lns_autotune"

#: The order candidates are offered in: today's default first, then the
#: neighbours.  Truncated by ``max_candidates``.
_ROW_RANK = (4, 8, 2, 1)

#: entry key → (geometry, max_candidates, reps): the search depth rides
#: along so that a shallow in-process tune can be superseded by a deeper
#: request (the same rule as the disk cache).
_MEM: dict = {}
_DISK: dict = {}         # cache path → loaded entries dict


def tiled(op: str, shape) -> bool:
    """True where the launch takes the tiled form, the one that reads the
    rows per block: a ⊞-MAC op whose contraction is longer than
    ``SHORT_STEPS``."""
    return op != "boxsum" and shape[2] > SHORT_STEPS


def fixed_geometry(op: str, shape):
    """The one geometry of a launch that reads no launch parameter: the
    short form's or the ⊞-reduce's (see the module's table)."""
    r, _, ct = shape
    if op == "boxsum":
        return (min(BOXSUM_THREADS, -(-r // 32) * 32), 1, ct)
    return (1, SHORT_THREADS, ct)


def geometry(op: str, shape, rows: int = DEFAULT_ROWS):
    """The geometry of a launch at ``rows`` rows per block: ``(rows, 32,
    32)`` where the tiled form runs, else :func:`fixed_geometry`."""
    if tiled(op, shape):
        return (rows, TILE_COLS, TILE_STEPS)
    return fixed_geometry(op, shape)


def rows_for(block_m: int) -> int:
    """Rows per block of an explicit ``MxNxK``: the largest of
    ``TILED_ROWS`` that is at most M."""
    return max(w for w in TILED_ROWS if w <= block_m)


def smem_bytes(op: str, blocks) -> int:
    """Static shared memory of one block at ``blocks``.

    Every form copies the Δ table (``s_tab``, ``MAX_TABLE`` + 1 pairs of
    int32: 8200 bytes).  The tiled form adds its two staging buffers of
    int2, ``s_a`` (2 × rows × 32 steps) and ``s_b`` (2 × 32 steps × 33
    columns), and ``s_pin`` (8 int32): 29 224 bytes at 8 rows.  All four
    row counts fit the 48 KiB budget, so the budget prunes nothing today;
    it stays so that a larger tile is refused before it is timed.
    """
    tab = (MAX_TABLE + 1) * 8
    if tuple(blocks[1:]) != (TILE_COLS, TILE_STEPS):
        return tab
    rows = blocks[0]
    return tab + 2 * rows * TILE_STEPS * 8 \
        + 2 * TILE_STEPS * (TILE_COLS + 1) * 8 + 8 * 4


def candidate_blocks(op: str, shape, *,
                     smem_budget: int = DEFAULT_SMEM_BUDGET,
                     max_candidates: int = 8):
    """The ranked geometries a measured search times for one launch.

    Where the tiled form runs: ``(w, 32, 32)`` for w in 4, 8, 2, 1 (today's
    4 first), those over ``smem_budget`` dropped, truncated to
    ``max_candidates``.  Anywhere else: the launch's one fixed geometry.
    """
    if op not in OPS:
        raise ValueError(f"unknown autotune op {op!r}; expected one of "
                         f"{OPS}")
    if not tiled(op, shape):
        return [fixed_geometry(op, shape)]
    ranked = [(w, TILE_COLS, TILE_STEPS) for w in _ROW_RANK
              if smem_bytes(op, (w, TILE_COLS, TILE_STEPS)) <= smem_budget]
    return ranked[:max_candidates] or [geometry(op, shape)]


def heuristic_blocks(op: str, shape, **kw):
    """Deterministic no-measurement choice: the best-ranked candidate,
    today's 4 rows where the tiled form runs."""
    return candidate_blocks(op, shape, **kw)[0]


# ------------------------------------------------------------------------
# Env / commit stamping + persistent cache
# ------------------------------------------------------------------------

def env_stamp() -> dict:
    """What a cache file is valid for: the torch version, and on a card
    its CUDA version and name; ``"cpu"`` without one."""
    if torch.cuda.is_available():
        return {"torch": torch.__version__, "cuda": torch.version.cuda,
                "device": torch.cuda.get_device_name(0)}
    return {"torch": torch.__version__, "device": "cpu"}


def _env_key() -> str:
    blob = json.dumps(env_stamp(), sort_keys=True).encode()
    return hashlib.sha1(blob).hexdigest()[:12]


@functools.lru_cache(maxsize=1)
def _git_commit() -> str:
    try:
        out = subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"], capture_output=True,
            text=True, timeout=5, cwd=os.path.dirname(__file__))
        return out.stdout.strip() or "unknown"
    except Exception:
        return "unknown"


def cache_dir() -> str:
    return os.environ.get("LNS_AUTOTUNE_DIR", DEFAULT_CACHE_DIR)


def cache_path() -> str:
    return os.path.join(cache_dir(), f"cache-{_env_key()}.json")


def _delta_key(spec: DeltaSpec) -> str:
    return f"{spec.kind}:{spec.d_max!r}:{spec.r!r}"


def entry_key(op: str, shape, fmt: LNSFormat, spec: DeltaSpec,
              interpret: bool) -> str:
    """The cache key of one launch; ``interpret`` is the lane (True: the
    CPU lane's plain versions, as the JAX package's interpret mode is its
    CPU lane; False: the card)."""
    r, c, ct = shape
    return (f"{op}|{r}x{c}x{ct}|{fmt.name}|{_delta_key(spec)}"
            f"|interpret={bool(interpret)}")


# Files already warned about this process (one RuntimeWarning per file,
# not one per lookup).
_WARNED_CORRUPT: set = set()


def _quarantine(path: str, err: Exception) -> None:
    """Move an unparsable cache file aside as ``<path>.corrupt`` so the
    next lookup re-tunes into a fresh file instead of failing forever
    (e.g. a crash mid-``_persist`` leaving a torn JSON)."""
    try:
        os.replace(path, path + ".corrupt")
    except OSError:
        pass  # read-only FS: still fall through to re-tune in memory
    if path not in _WARNED_CORRUPT:
        _WARNED_CORRUPT.add(path)
        warnings.warn(
            f"autotune cache {path} is corrupt ({err}); quarantined as "
            f"{path}.corrupt and re-tuning", RuntimeWarning, stacklevel=3)


def _load_disk() -> dict:
    path = cache_path()
    if path not in _DISK:
        entries = {}
        try:
            with open(path) as f:
                data = json.load(f)
            if not isinstance(data, dict):
                raise ValueError(f"expected object, got {type(data).__name__}")
            if data.get("env") == env_stamp():
                entries = data.get("entries", {})
        except OSError:
            pass  # missing file: first run in this env
        except ValueError as e:
            _quarantine(path, e)
        _DISK[path] = entries
    return _DISK[path]


def _persist(key: str, blocks, ms: float, search: dict) -> None:
    path = cache_path()
    entries = _load_disk()
    entries[key] = {"blocks": list(blocks), "ms": ms,
                    "commit": _git_commit(), "time": time.time(),
                    "search": search}
    try:
        os.makedirs(cache_dir(), exist_ok=True)
        with open(path, "w") as f:
            json.dump({"env": env_stamp(), "entries": entries}, f,
                      indent=1, sort_keys=True)
    except OSError:
        pass  # read-only FS etc.: the in-memory cache still holds the win


def clear_caches() -> None:
    """Drop the in-memory caches (tests; the JSON files stay)."""
    _MEM.clear()
    _DISK.clear()


# ------------------------------------------------------------------------
# Measurement
# ------------------------------------------------------------------------

def _capturing() -> bool:
    return torch.cuda.is_available() \
        and torch.cuda.is_current_stream_capturing()


def _can_measure(interpret: bool) -> bool:
    """Measure only on the card (the CPU lane reads no launch parameter),
    outside CUDA graph capture, and unless ``LNS_AUTOTUNE_DISABLE``."""
    if os.environ.get("LNS_AUTOTUNE_DISABLE") or interpret:
        return False
    return torch.cuda.is_available() and not _capturing()


def _measure_ms(fn, reps: int = 3) -> float:
    """Best-of-``reps`` time of ``fn()`` in ms after warm calls (min is
    robust to interference: one hiccup inflates a mean and misranks
    candidates).  ``fn`` returns a tensor.  On the card each timed call
    is bracketed by CUDA events on the current stream behind a spin kernel
    that holds the stream for a few times the call's host time, so the
    call's launches run back to back and the events read the card's time
    alone, not the wrapper's host work (a short launch takes less than its
    enqueue); a call that synchronizes inside reads more, never less.  On
    the CPU: ``time.perf_counter``.  Refuses to run during CUDA graph
    capture, where nothing launched is timed."""
    if _capturing():
        raise RuntimeError("the autotuner cannot time a launch during CUDA "
                           "graph capture; tune before capturing")
    out = fn()  # build, load and warm
    if isinstance(out, torch.Tensor) and out.is_cuda:
        dev = out.device
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev)
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            fn()
            host_s = time.perf_counter() - t0
            torch.cuda.synchronize(dev)
            # ~2 GHz: 4× the host time, and at least 50 µs.
            cycles = int(2.0e9 * (4 * host_s + 50e-6))
            best = float("inf")
            for _ in range(reps):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                torch.cuda._sleep(cycles)
                start.record(stream)
                fn()
                end.record(stream)
                end.synchronize()
                best = min(best, start.elapsed_time(end))
        return best
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best * 1e3


def _bench_launcher(op: str, shape, blocks, fmt: LNSFormat,
                    spec: DeltaSpec, interpret: bool):
    """A zero-arg callable that runs the real kernel at ``blocks`` on
    random operands of ``shape`` (made once, from seed 0), on the CPU lane
    when ``interpret`` and on the card otherwise.

    Times the *unfused* launch of each op through its counted wrapper; the
    fused launches (``lns_matmul_fused``, ``lns_matmul_dw_update``) consume
    the same entries: their epilogue is O(output) work once per output
    against O(CT) ⊞-MAC steps, so the ranking is the shared chain's.
    """
    from ..core.lns import encode
    from .lns_boxsum import lns_boxsum
    from .lns_matmul import (lns_matmul, lns_matmul_dw,
                             lns_matmul_dw_partials, lns_matmul_dx)
    if op not in OPS:
        raise ValueError(f"unknown autotune op {op!r}")
    r, c, ct = shape
    rows = blocks[0] if tiled(op, shape) else DEFAULT_ROWS
    device = torch.device("cpu" if interpret else "cuda")
    gen = torch.Generator(device=device).manual_seed(0)
    kw = dict(fmt=fmt, spec=spec)

    def enc(*s):
        a = encode(torch.randn(*s, generator=gen, device=device), fmt)
        return a.code, a.sign

    if op == "boxsum":
        x = enc(r, ct)
        return lambda: lns_boxsum(*x, **kw)[0]
    kw["block_rows"] = rows
    if op == "fwd":
        a, b = enc(r, ct), enc(ct, c)
        return lambda: lns_matmul(*a, *b, **kw)[0]
    if op == "dx":
        dy, w = enc(r, ct), enc(c, ct)
        return lambda: lns_matmul_dx(*dy, *w, **kw)[0]
    if op == "dw":
        x, dy = enc(ct, r), enc(ct, c)
        return lambda: lns_matmul_dw(*x, *dy, **kw)[0]
    # dw_partials: CT is one segment; time a canonical 2-segment batch.
    x, dy = enc(2 * ct, r), enc(2 * ct, c)
    return lambda: lns_matmul_dw_partials(*x, *dy, num_segments=2, **kw)[0]


def tune(op: str, shape, *, fmt: LNSFormat, spec: DeltaSpec,
         interpret: bool = False, smem_budget: int = DEFAULT_SMEM_BUDGET,
         max_candidates: int = 8, reps: int = 3, measure_fn=None,
         verbose: bool = False):
    """Measured search; returns ``(best_geometry, {geometry: ms})``.

    ``measure_fn(op, shape, blocks) -> ms`` overrides the real timing
    (tests inject deterministic stubs).  Does not consult or write any
    cache: :func:`lookup` wraps this with the cache discipline.  An op
    that reads no launch parameter has one candidate, timed all the same.
    """
    results = {}
    for blocks in candidate_blocks(op, shape, smem_budget=smem_budget,
                                   max_candidates=max_candidates):
        if measure_fn is not None:
            ms = float(measure_fn(op, shape, blocks))
        else:
            ms = _measure_ms(
                _bench_launcher(op, shape, blocks, fmt, spec, interpret),
                reps=reps)
        results[blocks] = ms
        if verbose:
            r, c, ct = blocks
            print(f"[autotune] {op} {shape}: {r}x{c}x{ct} -> {ms:.5f} ms")
    best = min(results, key=results.get)
    return best, results


def lookup(op: str, shape, *, fmt: LNSFormat, spec: DeltaSpec,
           interpret: bool = False, measure: "bool | None" = None,
           measure_fn=None, smem_budget: int = DEFAULT_SMEM_BUDGET,
           max_candidates: int = 8, reps: int = 3, verbose: bool = False):
    """The geometry ``blocks=auto`` resolves to for one kernel launch.

    A launch that reads no launch parameter gets its fixed geometry at
    once: nothing is measured or cached.  Otherwise: memory cache →
    persistent JSON cache → measured search (persisted).  ``measure=None``
    auto-detects (:func:`_can_measure`); a non-measurable miss returns
    :func:`heuristic_blocks` *without* caching it, so a later call on the
    card can still fill the real entry.

    Persisted entries record the search depth that produced them; an
    entry from a *shallower* search (fewer candidates or reps) than
    requested does not satisfy a measurable lookup: it is re-tuned and
    overwritten, so a quick tune can never pin the rows a full search
    would have chosen.  (When measurement is impossible, a shallow
    measured entry still beats the heuristic.)
    """
    if op not in OPS:
        raise ValueError(f"unknown autotune op {op!r}; expected one of "
                         f"{OPS}")
    if not tiled(op, shape):
        return fixed_geometry(op, shape)
    key = entry_key(op, shape, fmt, spec, interpret)
    cached = _MEM.get(key)
    if cached is not None and cached[1] >= max_candidates \
            and cached[2] >= reps:
        return cached[0]
    entry = _load_disk().get(key)
    if entry is not None:
        search = entry.get("search", {})
        if (search.get("max_candidates", 0) >= max_candidates
                and search.get("reps", 0) >= reps):
            blocks = tuple(entry["blocks"])
            _MEM[key] = (blocks, search.get("max_candidates", 0),
                         search.get("reps", 0))
            return blocks
    if measure is None:
        measure = _can_measure(interpret)
    if not measure:
        if cached is not None:
            return cached[0]
        if entry is not None:
            return tuple(entry["blocks"])
        return heuristic_blocks(op, shape, smem_budget=smem_budget,
                                max_candidates=max_candidates)
    best, results = tune(op, shape, fmt=fmt, spec=spec,
                         interpret=interpret, smem_budget=smem_budget,
                         max_candidates=max_candidates, reps=reps,
                         measure_fn=measure_fn, verbose=verbose)
    _MEM[key] = (best, max_candidates, reps)
    _persist(key, best, results[best],
             {"max_candidates": max_candidates, "reps": reps,
              "smem_budget": smem_budget})
    return best


def prime_matmul(m: int, k: int, n: int, *, fmt: LNSFormat,
                 spec: DeltaSpec, interpret: bool = False, **tune_kw):
    """Tune the three ⊞-MAC products of one (M, K) × (K, N) layer ahead of
    the steps that launch them (model setup, a bench's warmup).  Returns
    ``{op: geometry}``."""
    shapes = {"fwd": (m, n, k), "dx": (m, k, n), "dw": (k, n, m)}
    return {op: lookup(op, s, fmt=fmt, spec=spec, interpret=interpret,
                       **tune_kw)
            for op, s in shapes.items()}
