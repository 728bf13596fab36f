#!/usr/bin/env python3
"""Host render ms of a text page, for one checkout or several compared on
one host.

It times `parser.text_render.render_text_page` at 150 dpi over the timing
pages of the text-page fixtures (`tests/fixtures/*_pages.npz`: a Latin-1
page and each script's page of the same length, the pages phase 23 of
`chip_smoke.py` times): one untimed render, then the median of
`--repeats`. The texts are this checkout's, whichever tree draws them.

With several `--tree`s each checkout is timed in a process of its own,
in the order A B B A (`--rounds` times over), because a shared host's
speed drifts; a page a checkout refuses is left out of its report. It
prints one JSON object: per tree, per round, each page's ms.

    python -m morphik_core_tpu_torch.scripts.render_ms [--tree DIR ...] [--repeats 9] [--rounds 1]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
FIXTURES = ("text_pages", "rtl_pages", "mark_pages", "complex_pages", "nko_pages", "unicode17_pages")


def pages() -> dict:
    """{name: text} of every fixture's timing pages."""
    import numpy as np

    out = {}
    for name in FIXTURES:
        if not (ROOT / "tests" / "fixtures" / f"{name}.npz").exists():
            continue
        with np.load(ROOT / "tests" / "fixtures" / f"{name}.npz") as z:
            out.update(zip(z["timing_names"].tolist(), z["timing_texts"].tolist()))
    return out


def render_ms(texts: dict, repeats: int) -> dict:
    """{name: median ms} of the pages the imported parser draws."""
    import numpy as np

    from morphik_core_tpu_torch.parser.text_render import UnsupportedText, render_text_page

    out = {}
    for name, text in texts.items():
        try:
            render_text_page(text, 150)
        except UnsupportedText:
            continue
        times = []
        for _ in range(repeats):
            t = time.perf_counter()
            render_text_page(text, 150)
            times.append((time.perf_counter() - t) * 1e3)
        out[name] = float(np.median(times))
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", action="append", default=[], help="a checkout's root (repeatable; default this one)")
    ap.add_argument("--repeats", type=int, default=9)
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:   # the tree's package is first on PYTHONPATH
        print(json.dumps(render_ms(pages(), args.repeats)))
        return
    trees = [str(Path(t).resolve()) for t in args.tree] or [str(ROOT)]
    order = [t for _ in range(args.rounds) for t in trees + trees[::-1]]
    report = {t: [] for t in trees}
    for tree in order:
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(filter(None, [tree, os.environ.get("PYTHONPATH")])))
        res = subprocess.run([sys.executable, __file__, "--child", "--repeats", str(args.repeats)], env=env,
                             cwd=tree, check=True, capture_output=True, text=True)
        report[tree].append(json.loads(res.stdout.splitlines()[-1]))
    print(json.dumps(report))


if __name__ == "__main__":
    main()
