"""Cache-inspection CLI for the collective-algorithm autotuner.

Port of ``mpi4torch_tpu/tune/__main__.py``.  ``python -m
mpi4torch_tpu_torch.tune`` prints the cached winners table (collective,
dtype, size bucket, nranks, platform -> algorithm), so tuned picks are
debuggable without reading raw JSON.

* ``--show``  — the table (the default action);
* ``--json``  — the raw cache document instead of the table;
* ``--clear`` — delete the persisted cache file (selection falls back
  to the defaults; the file is safe to delete at any time).

The measurement sweep itself lives one module deeper:
``python -m mpi4torch_tpu_torch.tune.autotuner [--smoke]``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Iterable, List, Optional

from .autotuner import CACHE_VERSION, cache_path

_COLUMNS = ("collective", "dtype", "size<=", "nranks", "platform",
            "tiers", "algorithm", "source")


def _load_raw() -> Optional[dict]:
    try:
        with open(cache_path(), "r", encoding="utf-8") as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def _program_steps(ent: dict) -> int:
    """Step count of a synthesized entry's serialized IR program."""
    try:
        return sum(len(ph.get("steps", ()))
                   for ph in ent["program"]["phases"])
    except (KeyError, TypeError):
        return 0


def _rows(data: dict) -> List[tuple]:
    """Decode ``collective|dtype|bucket|nranks|platform`` keys into table
    rows; malformed entries are skipped, not fatal — this is a debugging
    surface over a best-effort cache.  Trailing key dimensions are
    optional and ordered (``|codec=…`` then ``|tiers=…``): codec-keyed
    winners render with the slot tag on the collective column,
    tier-keyed winners (csched tier-stack synthesis) fill the ``tiers``
    column (``-`` for flat keys).  Synthesized-program winners
    (``synth:<digest>`` entries carrying their serialized IR program)
    render distinctly from named algorithms: the digest in the algorithm
    column, ``synthesized(<n> steps)`` as the source.  Entries a
    self-tuning controller installed online (a live drift/crossover
    episode, not an offline sweep) carry a ``ctl`` provenance stamp and
    render as
    ``online-switched(<trigger>@epoch <n>, k steps)`` so an operator
    can tell which winners a controller episode picked."""
    rows = []
    entries = data.get("entries")
    if not isinstance(entries, dict):
        return rows
    for key, ent in sorted(entries.items()):
        if not (isinstance(key, str) and isinstance(ent, dict)):
            continue
        parts = key.split("|")
        algo = ent.get("algorithm")
        if not isinstance(algo, str):
            continue
        tiers = "-"
        if len(parts) > 5 and parts[-1].startswith("tiers="):
            tiers = parts[-1][len("tiers="):]
            parts = parts[:-1]
        if len(parts) == 6 and parts[5].startswith("codec="):
            # Codec-keyed winners (compressed traffic's own slots, and
            # codec=synth / codec=synth_q8 — the synthesis dimensions)
            # render with the slot tag on the collective column.
            parts = [parts[0] + "[" + parts[5][len("codec="):] + "]"] \
                + parts[1:5]
        if len(parts) != 5:
            continue
        collective, dtype, bucket, nranks, platform = parts
        ctl = ent.get("ctl")
        if isinstance(ctl, dict) and ctl.get("provenance") \
                == "online-switched":
            source = (f"online-switched({ctl.get('trigger', '?')}"
                      f"@epoch {ctl.get('epoch', '?')}")
            if isinstance(ent.get("program"), dict):
                source += f", {_program_steps(ent)} steps"
            source += ")"
        elif algo.startswith("synth:") and isinstance(ent.get("program"),
                                                      dict):
            source = f"synthesized({_program_steps(ent)} steps)"
        elif ent.get("measurements"):
            source = "measured"
        else:
            source = "recorded"
        rows.append((collective, dtype, bucket, nranks, platform, tiers,
                     algo, source))
    return rows


def _print_table(rows: List[tuple]) -> None:
    widths = [max(len(str(c)) for c in col)
              for col in zip(_COLUMNS, *rows)] if rows else \
        [len(c) for c in _COLUMNS]
    fmt = "  ".join(f"{{:<{w}}}" for w in widths)
    print(fmt.format(*_COLUMNS))
    print(fmt.format(*("-" * w for w in widths)))
    for row in rows:
        print(fmt.format(*row))


def _main(argv: Iterable[str]) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m mpi4torch_tpu_torch.tune",
        description="Inspect or clear the persistent autotuner cache.")
    parser.add_argument("--show", action="store_true",
                        help="print the cached winners table (default)")
    parser.add_argument("--json", action="store_true",
                        help="print the raw cache JSON instead")
    parser.add_argument("--clear", action="store_true",
                        help="delete the persisted cache file")
    args = parser.parse_args(list(argv))

    path = cache_path()
    if args.clear:
        try:
            os.remove(path)
            print(f"removed {path}")
        except FileNotFoundError:
            print(f"no cache file at {path}")
        except OSError as e:
            print(f"could not remove {path}: {e}", file=sys.stderr)
            return 1
        return 0

    data = _load_raw()
    if args.json:
        print(json.dumps(data, indent=1, sort_keys=True))
        return 0
    print(f"cache file: {path}")
    if data is None:
        print("no cache (missing or unreadable file) — auto selection "
              "uses the defaults")
        return 0
    if data.get("version") != CACHE_VERSION:
        print(f"cache version {data.get('version')!r} != expected "
              f"{CACHE_VERSION} — the file is ignored by selection "
              "(safe to --clear)")
        return 0
    rows = _rows(data)
    if not rows:
        print("cache holds no winners yet — run the sweep "
              "(python -m mpi4torch_tpu_torch.tune.autotuner)")
        return 0
    _print_table(rows)
    print(f"{len(rows)} cached winner(s)")
    return 0


if __name__ == "__main__":
    sys.exit(_main(sys.argv[1:]))
