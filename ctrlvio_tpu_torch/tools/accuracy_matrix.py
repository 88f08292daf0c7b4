"""Anti-inverse-crime accuracy matrix through the port (counterpart of
`tools/accuracy_matrix.py`).

Ground truth drawn from the estimator's own order-4 / 0.05 s B-spline
family is an inverse crime. This tool runs the full e2e bench (noise on,
the visual self-bootstrap, the streaming path on the card) over ground-
truth families x seeds x motion speeds:

  spline    - in the estimator's class (the control)
  fine      - a 0.01 s-knot spline: content the 0.05 s basis cannot hold
  lissajous - an analytic curve, not a B-spline of any knot spacing

    python -m ctrlvio_tpu_torch.tools.accuracy_matrix [--preset gpu|cpu-smoke]
        [--duration S] [--out build/accuracy_torch.json]

Each row is one `python -m ctrlvio_tpu_torch.bench` child, one after
another. The artifact (JSON) holds the rows and the gates; the markdown
table goes to stderr; the last line of stdout is one JSON object naming
the artifact and the rows' exit codes. Exits 1 if any row failed.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

# families x seeds x speeds: 10 rows, the shape of the paper's seq1-10
# table; speeds scale the ground-truth dynamics (1.4x ~ brisk handheld)
MATRIX = [
    ("spline", 3, 1.0),
    ("spline", 5, 1.0),
    ("spline", 3, 1.4),
    ("fine", 3, 1.0),
    ("fine", 5, 1.0),
    ("fine", 3, 1.4),
    ("lissajous", 3, 1.0),
    ("lissajous", 5, 1.0),
    ("lissajous", 3, 1.4),
    ("lissajous", 5, 1.4),
]


def run_row(gt, seed, speed, preset, duration=None, timeout=3600):
    """One bench child at this row; returns its record: the row, the
    child's exit code and wall seconds, the fields of its JSON line, and
    the tail of its stderr when it failed."""
    cmd = [sys.executable, "-m", "ctrlvio_tpu_torch.bench",
           "--preset", preset, "--gt", gt, "--seed", str(seed),
           "--speed", str(speed)]
    if duration:
        cmd += ["--duration", str(duration)]
    t0 = time.time()
    r = subprocess.run(cmd, cwd=ROOT, timeout=timeout, capture_output=True,
                       text=True)
    line = next((ln for ln in reversed(r.stdout.splitlines())
                 if ln.startswith("{")), None)
    row = dict(gt=gt, seed=seed, speed=speed, rc=r.returncode,
               wall_s=round(time.time() - t0, 1))
    if line:
        row.update(json.loads(line))
    if r.returncode != 0:
        tail = [ln for ln in r.stderr.splitlines() if ln.strip()][-3:]
        row["error"] = " | ".join(tail)
    return row


def artifact(rows, preset):
    return {
        "what": "anti-inverse-crime accuracy matrix: full bench (noise ON, "
                "visual self-bootstrap, streaming path) over GT families "
                "the estimator's basis cannot represent",
        "preset": preset,
        "timestamp": time.strftime("%Y-%m-%d %H:%M:%S"),
        "gates": {"ate_cm": 10.0 if preset == "gpu" else 6.0,
                  "ld_err_us": 2.0},
        "rows": rows,
    }


def table(rows) -> str:
    lines = ["| GT family | seed | speed | rc | ATE online (cm) | ATE "
             "post-hoc (cm) | ld err (us) | fps |",
             "|---|---|---|---|---|---|---|---|"]
    for r in rows:
        lines.append(f"| {r['gt']} | {r['seed']} | {r['speed']} | "
                     f"{r['rc']} | {r.get('ate_online_cm', 'FAIL')} | "
                     f"{r.get('ate_posthoc_cm', 'FAIL')} | "
                     f"{r.get('ld_err_us', 'FAIL')} | {r.get('value', 0)} |")
    return "\n".join(lines)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m ctrlvio_tpu_torch.tools.accuracy_matrix")
    ap.add_argument("--preset", choices=["gpu", "cpu-smoke"], default="gpu")
    ap.add_argument("--duration", type=float, default=None)
    ap.add_argument("--out", default=str(ROOT / "build" /
                                         "accuracy_torch.json"))
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)

    rows = []
    for gt, seed, speed in MATRIX:
        print(f"[matrix] {gt} seed={seed} speed={speed} ...",
              file=sys.stderr, flush=True)
        row = run_row(gt, seed, speed, args.preset, args.duration)
        rows.append(row)
        print(f"[matrix]   -> rc={row['rc']} "
              f"ATE online {row.get('ate_online_cm', '?')} cm / "
              f"post-hoc {row.get('ate_posthoc_cm', '?')} cm, "
              f"ld err {row.get('ld_err_us', '?')} us, "
              f"{row.get('value', '?')} fps ({row['wall_s']}s)",
              file=sys.stderr, flush=True)

    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(artifact(rows, args.preset), indent=1))
    print(f"[matrix] artifact -> {out}", file=sys.stderr)
    print(table(rows), file=sys.stderr)
    failed = [r for r in rows if r["rc"] != 0]
    print(json.dumps({"tool": "accuracy_matrix", "artifact": str(out),
                      "rows": len(rows), "failed": len(failed),
                      "rcs": [r["rc"] for r in rows]}), flush=True)
    sys.exit(1 if failed else 0)


if __name__ == "__main__":
    main()
