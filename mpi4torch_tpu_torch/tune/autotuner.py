"""Measurement-driven algorithm autotuner with a persistent cache.

Port of ``mpi4torch_tpu/tune/autotuner.py``.  The selector
(:mod:`mpi4torch_tpu_torch.tune`) deviates from ``ring`` only on
evidence; this module produces it: it times every applicable algorithm
per ``(collective, dtype, nbytes-bucket, nranks, platform)`` key under
:func:`~mpi4torch_tpu_torch.run_spmd`, records the winner in an
in-process table, and persists the table to a JSON file so later
processes select tuned algorithms without measuring.

Cache file contract (the JAX package's format, version
:data:`CACHE_VERSION`, so one package's file loads in the other):

* location — ``$MPI4TORCH_TPU_TORCH_TUNE_CACHE`` if set, else
  ``~/.cache/mpi4torch_tpu_torch/tune_cache.json``.  It is never the JAX
  package's default file: on the CPU both would write ``platform=cpu``
  keys, and one package's timings would steer the other's selection;
* versioned — a mismatched, corrupt or truncated file is ignored
  (selection falls back to the defaults; the file is safe to delete);
* written atomically (a unique tempfile + ``os.replace`` under an
  exclusive ``flock`` on ``<cache>.lock``, merging the entries another
  process persisted meanwhile) and best-effort: an unwritable directory
  degrades to in-process tuning.

The platform dimension of a key is ``"gpu"`` for a CUDA world and
``"cpu"`` for a CPU world (the JAX package's platform names, so a key
built for the same inputs is byte-identical to JAX's ``make_key``).  It
comes from the device of the world that runs the collective, never from
whether a card is present.  Rank threads may record and look up at once:
the in-process table is guarded by a lock.

Message sizes are bucketed to the next power of two.  ``python -m
mpi4torch_tpu_torch.tune.autotuner [--smoke] [--sweep] [--device cpu]``
runs the sweep and prints the JSON report.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np
import torch

from .. import config as _config
from .registry import available_algorithms, get_algorithm

# v2: per-size measurement switched from median-of-k to MIN-of-k; v3:
# synthesized-program keys grew a tier dimension (|tiers=AxB...) and
# fold steps carry tier annotations that change synth digests.  Entries
# of another version are ignored.
CACHE_VERSION = 3

CACHE_ENV = "MPI4TORCH_TPU_TORCH_TUNE_CACHE"

_lock = threading.RLock()
_mem: Dict[str, dict] = {}
_from_disk: set = set()
_file_loaded = False
_generation = 0


def cache_path() -> str:
    """Path of the persistent cache file (see module docstring)."""
    env = os.environ.get(CACHE_ENV)
    if env:
        return env
    return os.path.join(os.path.expanduser("~"), ".cache",
                        "mpi4torch_tpu_torch", "tune_cache.json")


def _bucket(nbytes: int) -> int:
    """Next power of two >= nbytes (>= 1): the cache's size key."""
    nbytes = max(int(nbytes), 1)
    return 1 << (nbytes - 1).bit_length()


def bucket_nbytes(nbytes: int) -> int:
    """The power-of-two bucket a payload of ``nbytes`` keys into.
    Serving's :func:`~mpi4torch_tpu_torch.serve.latency_report` shows
    which bucket the decode message sizes share with training tail
    buckets: the aliasing the selector's latency-tier guard exists
    for."""
    return _bucket(nbytes)


def platform_of(device) -> str:
    """The cache's platform token of a device: ``"gpu"`` for CUDA,
    ``"cpu"`` otherwise (the JAX package's platform names)."""
    return "gpu" if torch.device(device).type == "cuda" else "cpu"


def _platform() -> str:
    """The platform of the world running on this thread: the Mode A
    region's, else the rank world's; on the default one-rank world, the
    device an entry point runs on (``runtime.resolve_device``: the card,
    and a ``RuntimeError`` on a machine without one)."""
    from ..ops.spmd import _current_region
    from ..runtime import current_rank_context, resolve_device

    region = _current_region()
    dev = region.world.device if region is not None else None
    if dev is None:
        ctx = current_rank_context()
        dev = ctx.world.device if ctx is not None else None
    if dev is None:
        dev = resolve_device(None)
    return platform_of(dev)


def dtype_token(dtype) -> str:
    """A dtype as the JAX package's keys name it (``str(np.dtype(..))``):
    ``"float32"``, ``"bfloat16"``, ``"int32"``; torch dtypes map to the
    same names, strings pass as they are."""
    if isinstance(dtype, str):
        return dtype
    if isinstance(dtype, torch.dtype):
        return str(dtype)[len("torch."):]
    return str(np.dtype(dtype))


def _codec_name(codec) -> Optional[str]:
    """A codec dimension value (Codec object, name, or None) as a
    cache-key token."""
    if codec is None:
        return None
    return getattr(codec, "name", codec)


def _tiers_token(tiers) -> Optional[str]:
    """A tier-stack dimension value (a tuple of factors, an ``AxBxC``
    string, or None) as a cache-key token."""
    if tiers is None:
        return None
    if isinstance(tiers, str):
        return tiers
    return "x".join(str(int(g)) for g in tiers)


def make_key(collective: str, dtype, nbytes: int, nranks: int,
             platform: Optional[str] = None, codec=None,
             tiers=None, transition: Optional[str] = None) -> str:
    """The cache key: ``collective|dtype|bucket|nranks|platform``, then
    the optional dimensions in order (``|codec=``: compressed traffic's
    own winners; ``|tiers=``: tier-synthesis winners of one tier stack;
    ``|transition=``: a reshard transition's winner)."""
    if platform is None:
        platform = _platform()
    key = "|".join([collective, dtype_token(dtype), str(_bucket(nbytes)),
                    str(int(nranks)), platform])
    name = _codec_name(codec)
    if name is not None:
        key += "|codec=" + str(name)
    tok = _tiers_token(tiers)
    if tok is not None:
        key += "|tiers=" + str(tok)
    if transition is not None:
        key += "|transition=" + str(transition)
    return key


def _validate_winner(collective: str, algorithm: str,
                     ent: Optional[dict] = None) -> None:
    """A winner name is validated against the registry that owns it:
    reshard entries name a planner strategy, ``synth:<digest>`` entries a
    synthesized IR program (the entry carries the serialized program,
    which installs on success, so a persisted winner is lowerable right
    after lookup), everything else a collective algorithm.  Raises on
    unknown names (``record``); ``lookup`` ignores such stale entries."""
    if isinstance(algorithm, str) and algorithm.startswith("synth:"):
        from ..csched import synth as _synth

        _synth.validate_entry(algorithm,
                              None if ent is None else ent.get("program"))
        return
    if collective == "reshard":
        from ..reshard.plan import STRATEGIES

        if algorithm not in STRATEGIES:
            raise ValueError(
                f"unknown reshard strategy {algorithm!r}; expected one "
                f"of {STRATEGIES}")
        return
    get_algorithm(algorithm)


def _valid_entries(data) -> Dict[str, dict]:
    """The well-formed entries of a cache document of this version."""
    if not isinstance(data, dict) or data.get("version") != CACHE_VERSION:
        return {}
    entries = data.get("entries")
    if not isinstance(entries, dict):
        return {}
    return {key: ent for key, ent in entries.items()
            if isinstance(key, str) and isinstance(ent, dict)
            and isinstance(ent.get("algorithm"), str)}


def _load() -> None:
    """Merge the disk cache into the in-process table, once.  Any defect
    (missing file, bad JSON, wrong version, malformed entries) reads as
    no cache."""
    global _file_loaded
    with _lock:
        if _file_loaded:
            return
        _file_loaded = True
        try:
            with open(cache_path(), "r", encoding="utf-8") as f:
                data = json.load(f)
        except (OSError, ValueError):
            return
        for key, ent in _valid_entries(data).items():
            if key not in _mem:
                _mem[key] = ent
                _from_disk.add(key)


def _save() -> None:
    """Atomic, concurrency-safe, best-effort persist of the in-process
    table: under an exclusive ``flock`` on ``<cache>.lock``, read the
    file, union the entries it holds that this process does not, write a
    unique tempfile in the cache directory and ``os.replace`` it over the
    cache.  Readers only ever see a complete document; without ``flock``
    the merge still narrows the race to the read-replace window."""
    import contextlib
    import tempfile

    path = cache_path()
    try:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

        @contextlib.contextmanager
        def _locked():
            try:
                import fcntl
                fd = os.open(path + ".lock", os.O_CREAT | os.O_RDWR, 0o644)
            except (ImportError, OSError):
                yield
                return
            try:
                try:
                    fcntl.flock(fd, fcntl.LOCK_EX)
                except OSError:
                    pass  # a filesystem without flock: merge-only safety
                yield
            finally:
                os.close(fd)

        with _locked():
            entries = dict(_mem)
            try:
                with open(path, "r", encoding="utf-8") as f:
                    on_disk = json.load(f)
                for key, ent in _valid_entries(on_disk).items():
                    entries.setdefault(key, ent)
            except (OSError, ValueError):
                pass
            fd, tmp = tempfile.mkstemp(
                dir=os.path.dirname(path) or ".", prefix=".tune_cache.",
                suffix=".tmp")
            try:
                with os.fdopen(fd, "w", encoding="utf-8") as f:
                    json.dump({"version": CACHE_VERSION, "entries": entries},
                              f, indent=1, sort_keys=True)
                os.replace(tmp, path)
            except BaseException:
                try:
                    os.remove(tmp)
                except OSError:
                    pass
                raise
    except OSError:
        pass


def lookup(collective: str, dtype, nbytes: int, nranks: int,
           platform: Optional[str] = None, codec=None, tiers=None,
           transition: Optional[str] = None) -> Optional[dict]:
    """The cached entry for this key, or None.  Entries naming an
    algorithm (or strategy, or program) the owning registry does not
    accept are ignored."""
    from ..obs import metrics as _metrics

    _load()
    try:
        key = make_key(collective, dtype, nbytes, nranks, platform,
                       codec=codec, tiers=tiers, transition=transition)
    except RuntimeError:
        # No world and no card: no platform to key on, so no winner (a
        # host-side plan or pick on a machine without a card).
        key = None
    with _lock:
        ent = _mem.get(key)
    if ent is None:
        _metrics.inc("tune_cache_misses_total",
                     help="autotuner cache lookups that found no winner")
        return None
    try:
        _validate_winner(collective, ent["algorithm"], ent)
    except (ValueError, KeyError, TypeError):
        _metrics.inc("tune_cache_misses_total")
        return None
    _metrics.inc("tune_cache_hits_total",
                 help="autotuner cache lookups serving a cached winner")
    return ent


def lookup_algorithm(collective: str, dtype, nbytes: int, nranks: int,
                     platform: Optional[str] = None,
                     codec=None, tiers=None,
                     transition: Optional[str] = None) -> Optional[str]:
    ent = lookup(collective, dtype, nbytes, nranks, platform, codec=codec,
                 tiers=tiers, transition=transition)
    return None if ent is None else ent["algorithm"]


def entry_from_disk(collective: str, dtype, nbytes: int, nranks: int,
                    platform: Optional[str] = None, codec=None,
                    tiers=None) -> bool:
    """True when this key's entry was loaded from the persisted file
    rather than measured in this process."""
    _load()
    key = make_key(collective, dtype, nbytes, nranks, platform,
                   codec=codec, tiers=tiers)
    with _lock:
        return key in _from_disk


def record(collective: str, dtype, nbytes: int, nranks: int,
           algorithm: str, platform: Optional[str] = None,
           measurements: Optional[dict] = None,
           persist: bool = True, codec=None, tiers=None,
           transition: Optional[str] = None,
           program: Optional[dict] = None,
           ctl: Optional[dict] = None) -> str:
    """Store a winner for a key (and persist it); bumps
    :func:`generation`, which the program and plan caches key on.
    ``program`` carries a synthesized winner's serialized IR program
    (required for ``synth:<digest>`` names); ``ctl`` the provenance stamp
    of a winner a controller installed online."""
    global _generation
    _load()
    key = make_key(collective, dtype, nbytes, nranks, platform,
                   codec=codec, tiers=tiers, transition=transition)
    ent = {"algorithm": algorithm, "measured_at": time.time()}
    if program is not None:
        ent["program"] = program
    if ctl is not None:
        ent["ctl"] = dict(ctl)
    _validate_winner(collective, algorithm, ent)
    name = _codec_name(codec)
    if name is not None:
        ent["codec"] = str(name)
    tok = _tiers_token(tiers)
    if tok is not None:
        ent["tiers"] = str(tok)
    if measurements:
        ent["measurements"] = measurements
    with _lock:
        _mem[key] = ent
        _from_disk.discard(key)
        _generation += 1
        if persist:
            _save()
    return key


def generation() -> int:
    """Monotonic counter bumped on every cache mutation; the program
    cache (``csched.programs.cached``) and the reshard plan caches key on
    it."""
    return _generation


def clear(remove_file: bool = False) -> None:
    """Drop the in-process table (and with ``remove_file`` the persisted
    file); the next lookup re-reads the file, so ``clear()`` alone
    round-trips the persisted entries."""
    global _file_loaded, _generation
    with _lock:
        _mem.clear()
        _from_disk.clear()
        _file_loaded = False
        _generation += 1
        if remove_file:
            try:
                os.remove(cache_path())
            except OSError:
                pass


# ---------------------------------------------------------------------------
# Measurement
# ---------------------------------------------------------------------------

SMOKE_SIZES = (1 << 10, 1 << 14, 1 << 18)                 # 1 KiB -> 256 KiB
DEFAULT_SIZES = tuple(1 << s for s in range(10, 27, 2))   # 1 KiB -> 64 MiB


def _candidates(nranks: int, collective: str = "allreduce") -> List[str]:
    return [name for name in available_algorithms()
            if get_algorithm(name).applicable(nranks, collective)]


def _time_step(step, x, iters: int, device=None) -> float:
    """MIN-of-k seconds a step on the host clock, the device synchronised
    after every call (timing noise is one-sided: a preempted sample is
    only ever slower, so the minimum is the robust estimate and one bad
    sample cannot flip a persisted winner).  Two untimed calls first
    absorb first-use costs (a kernel's build, allocator growth)."""
    def force(out):
        if device is not None and torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)
        return out

    force(step(x))
    force(step(x))
    times = []
    for _ in range(max(int(iters), 1)):
        t0 = time.perf_counter()
        force(step(x))
        times.append(time.perf_counter() - t0)
    return min(times)


def _sweep_world(nranks, device, dtype):
    from ..runtime import resolve_device

    dev = resolve_device(device)
    if nranks is None:
        from ..ops.spmd import _device_count
        nranks = _device_count(dev)
    if dtype is None:
        dtype = torch.float32
    return dev, int(nranks), dtype


def autotune_allreduce(sizes: Optional[Sequence[int]] = None,
                       nranks: Optional[int] = None,
                       dtype=None, iters: int = 5,
                       persist: bool = True,
                       apply_crossover: bool = True,
                       codecs: Sequence = (None,),
                       device=None) -> dict:
    """Time every applicable Allreduce algorithm at each payload size
    under ``run_spmd(nranks=)`` on ``device`` (the card unless the caller
    asks for another), record the winners in the cache, and (by default)
    set :func:`config.set_latency_crossover_bytes` and
    :func:`config.set_bandwidth_crossover_bytes` from the measured
    crossovers.

    ``codecs`` is the sweep's codec dimension: each non-``None`` entry
    re-runs the sweep with that compression over the algorithms the
    codec rides, and records under the cache's codec-keyed dimension;
    the crossovers read only the exact sweep.  A candidate that raises is
    reported under ``error`` and the sweep goes on.

    Returns the report: per size and algorithm the seconds a step and
    GB/s, the winners, both crossovers, and ``tuned_from_cache: False``."""
    from .. import MPI_SUM, COMM_WORLD
    from ..ops.spmd import run_spmd

    dev, n, dtype = _sweep_world(nranks, device, dtype)
    sizes = tuple(sizes) if sizes else DEFAULT_SIZES
    platform = platform_of(dev)
    itemsize = torch.empty((), dtype=dtype).element_size()

    report = {
        "collective": "allreduce",
        "nranks": n,
        "dtype": dtype_token(dtype),
        "platform": platform,
        "cache_file": cache_path(),
        "tuned_from_cache": False,
        "entries": {},
    }

    def step_fn(algorithm, compression):
        def body(x):
            return COMM_WORLD.Allreduce(x, MPI_SUM, algorithm=algorithm,
                                        compression=compression or False)

        return run_spmd(body, nranks=n, device=dev)

    def sweep_one(nbytes, x, wire, codec):
        from ..compress import codec_applicable, get_codec

        if codec is None:
            names = _candidates(n)
        else:
            cobj = get_codec(codec)
            names = [a for a in _candidates(n)
                     if codec_applicable(cobj, dtype, algorithm=a)]
        per = {}
        for name in names:
            try:
                dt = _time_step(step_fn(name, codec), x, iters, dev)
            except Exception as e:  # noqa: BLE001 — the sweep must finish
                per[name] = {"error": f"{type(e).__name__}: {e}"[:200]}
                continue
            per[name] = {"seconds_per_step": dt,
                         "gbps": round(wire / dt / 1e9, 4)}
        timed = {k: v for k, v in per.items() if "seconds_per_step" in v}
        if not timed:
            return {"algorithms": per}
        winner = min(timed, key=lambda k: timed[k]["seconds_per_step"])
        record("allreduce", dtype, int(nbytes), n, winner,
               platform=platform, measurements={
                   k: v["seconds_per_step"] for k, v in timed.items()},
               persist=persist, codec=codec)
        return {
            "algorithms": per,
            "winner": winner,
            "winner_latency_optimal": get_algorithm(winner).latency_optimal,
            "winner_bandwidth_optimal":
                get_algorithm(winner).bandwidth_optimal,
        }

    for nbytes in sizes:
        nelem = max(1, int(nbytes) // itemsize)
        x = torch.ones((nelem,), dtype=dtype, device=dev)
        wire = 2.0 * (n - 1) / n * nelem * itemsize if n > 1 \
            else float(nelem * itemsize)
        ent = sweep_one(nbytes, x, wire, None) \
            if None in tuple(codecs) else {"algorithms": {}}
        for codec in codecs:
            if codec is None:
                continue
            ent.setdefault("codecs", {})[str(_codec_name(codec))] = \
                sweep_one(nbytes, x, wire, codec)
        report["entries"][str(int(nbytes))] = ent

    crossover = _crossover_from(report["entries"])
    report["crossover_bytes"] = crossover
    if apply_crossover and crossover is not None:
        _config.set_latency_crossover_bytes(crossover)
        report["applied_latency_crossover_bytes"] = crossover
    bandwidth = _bandwidth_crossover_from(report["entries"])
    report["bandwidth_crossover_bytes"] = bandwidth
    if apply_crossover and bandwidth is not None:
        _config.set_bandwidth_crossover_bytes(bandwidth)
        report["applied_bandwidth_crossover_bytes"] = bandwidth
    return report


def _crossover_from(entries: dict) -> Optional[int]:
    """Largest measured size whose winner is latency-optimal: the
    ring/latency crossover (None when the latency regime was not
    reached)."""
    best = None
    for size_str, ent in entries.items():
        if ent.get("winner_latency_optimal"):
            size = int(size_str)
            best = size if best is None else max(best, size)
    return best


def _bandwidth_crossover_from(entries: dict) -> Optional[int]:
    """Smallest measured size from which a bandwidth-tier algorithm wins
    at every larger measured size too: the ring/multipath crossover
    (None when the largest size is not won by the bandwidth tier)."""
    sized = sorted((int(s), ent) for s, ent in entries.items()
                   if "winner" in ent)
    best = None
    for size, ent in reversed(sized):
        if not ent.get("winner_bandwidth_optimal"):
            break
        best = size
    return best


def ensure_tuned_allreduce(sizes: Optional[Sequence[int]] = None,
                           nranks: Optional[int] = None,
                           dtype=None, iters: int = 5,
                           persist: bool = True,
                           apply_crossover: bool = True,
                           device=None) -> dict:
    """:func:`autotune_allreduce`, but when every size already has a
    cached winner the report is built from the cache
    (``tuned_from_cache: True``, no measurement); ``from_disk`` says
    whether every served entry came from the persisted file."""
    dev, n, dtype = _sweep_world(nranks, device, dtype)
    sizes = tuple(sizes) if sizes else DEFAULT_SIZES
    platform = platform_of(dev)

    cached = {}
    from_disk = True
    for nbytes in sizes:
        ent = lookup("allreduce", dtype, int(nbytes), n, platform)
        if ent is None:
            return autotune_allreduce(sizes=sizes, nranks=n, dtype=dtype,
                                      iters=iters, persist=persist,
                                      apply_crossover=apply_crossover,
                                      device=dev)
        from_disk = from_disk and entry_from_disk(
            "allreduce", dtype, int(nbytes), n, platform)
        cached[str(int(nbytes))] = {
            "winner": ent["algorithm"],
            "winner_latency_optimal":
                get_algorithm(ent["algorithm"]).latency_optimal,
            "winner_bandwidth_optimal":
                get_algorithm(ent["algorithm"]).bandwidth_optimal,
            "measurements": ent.get("measurements"),
        }
    crossover = _crossover_from(cached)
    if apply_crossover and crossover is not None:
        _config.set_latency_crossover_bytes(crossover)
    bandwidth = _bandwidth_crossover_from(cached)
    if apply_crossover and bandwidth is not None:
        _config.set_bandwidth_crossover_bytes(bandwidth)
    return {
        "collective": "allreduce",
        "nranks": n,
        "dtype": dtype_token(dtype),
        "platform": platform,
        "cache_file": cache_path(),
        "tuned_from_cache": True,
        "from_disk": from_disk,
        "entries": cached,
        "crossover_bytes": crossover,
        "bandwidth_crossover_bytes": bandwidth,
    }


def _main(argv: Iterable[str]) -> int:
    argv = list(argv)
    smoke = "--smoke" in argv
    device = None
    if "--device" in argv:
        device = argv[argv.index("--device") + 1]
    nranks = None
    if "--nranks" in argv:
        nranks = int(argv[argv.index("--nranks") + 1])
    sizes = SMOKE_SIZES if smoke else DEFAULT_SIZES
    if "--sweep" in argv:
        # Always measure: a fresh sizes x algorithms table (the winners
        # still persist).
        report = autotune_allreduce(sizes=sizes, nranks=nranks,
                                    iters=2 if smoke else 5, device=device)
    else:
        report = ensure_tuned_allreduce(sizes=sizes, nranks=nranks,
                                        iters=2 if smoke else 5,
                                        device=device)
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(_main(sys.argv[1:]))
