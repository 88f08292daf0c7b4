"""The port's accuracy matrix and `entry()` against the repository's:
`tools/accuracy_matrix.py`'s matrix, artifact and exit code (rows
stubbed), and `__graft_entry__.entry()`'s solve on the same arguments.
`ne_ab` and `profile_serve` are in `test_torch_tools_serve.py` (kept
apart to hold each file under 90 s)."""

import ast
import importlib.util
import json
import subprocess
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from ctrlvio_tpu_torch.entry import entry
from ctrlvio_tpu_torch.solver import lm
from ctrlvio_tpu_torch.solver.layout import SolveOptions
from ctrlvio_tpu_torch.tools import accuracy_matrix
from ctrlvio_tpu_torch.utils.convert import from_numpy, tensor
from tests.torch_parity import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
JAX_MATRIX_PY = ROOT / "tools" / "accuracy_matrix.py"


def jax_tool():
    spec = importlib.util.spec_from_file_location("jax_accuracy_matrix",
                                                  JAX_MATRIX_PY)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def jax_artifact_keys():
    """The keys of the artifact `tools/accuracy_matrix.py::main` writes."""
    tree = ast.parse(JAX_MATRIX_PY.read_text())
    art = next(n for n in ast.walk(tree) if isinstance(n, ast.Assign)
               and getattr(n.targets[0], "id", None) == "art")
    return [k.value for k in art.value.keys]


def test_matrix_equals_jax_tool():
    assert accuracy_matrix.MATRIX == jax_tool().MATRIX
    assert len(accuracy_matrix.MATRIX) == 10


def test_run_row_runs_the_port_bench(monkeypatch):
    """A row is one `python -m ctrlvio_tpu_torch.bench` child with the
    row's flags; its last JSON line fills the record, a failure keeps the
    tail of stderr."""
    calls = []

    def fake(cmd, **kw):
        calls.append(cmd)
        ok = "--duration" not in cmd
        return subprocess.CompletedProcess(
            cmd, 0 if ok else 1,
            stdout='[bench] x\n{"value": 1.5, "ate_online_cm": 1.2}\n'
            if ok else "", stderr="a\nb\n[bench] FAIL accuracy gates\n")

    monkeypatch.setattr(accuracy_matrix.subprocess, "run", fake)
    row = accuracy_matrix.run_row("lissajous", 5, 1.4, "gpu")
    assert calls[0][1:] == ["-m", "ctrlvio_tpu_torch.bench", "--preset",
                            "gpu", "--gt", "lissajous", "--seed", "5",
                            "--speed", "1.4"]
    assert row["rc"] == 0 and row["value"] == 1.5
    assert (row["gt"], row["seed"], row["speed"]) == ("lissajous", 5, 1.4)
    bad = accuracy_matrix.run_row("fine", 3, 1.0, "cpu-smoke", duration=6)
    assert calls[1][-2:] == ["--duration", "6"]
    assert bad["rc"] == 1 and "FAIL accuracy gates" in bad["error"]
    assert "value" not in bad


@pytest.mark.parametrize("preset,failing", [("gpu", None),
                                            ("cpu-smoke", ("fine", 5, 1.0))])
def test_artifact_table_and_exit_code(monkeypatch, tmp_path, capsys, preset,
                                      failing):
    """Rows stubbed: the artifact has the JAX tool's fields and the
    preset's gates (10 cm on the card, 6 cm on the CPU; 2 us), the table
    one line a row; a failed row exits 1, none exits 0."""
    def fake_row(gt, seed, speed, p, duration=None, timeout=3600):
        if (gt, seed, speed) == failing:
            return dict(gt=gt, seed=seed, speed=speed, rc=1, wall_s=1.0,
                        error="boom")
        return dict(gt=gt, seed=seed, speed=speed, rc=0, wall_s=1.0,
                    value=1.0, ate_online_cm=1.0, ate_posthoc_cm=0.5,
                    ld_err_us=0.1)

    monkeypatch.setattr(accuracy_matrix, "run_row", fake_row)
    out = tmp_path / "accuracy.json"
    with pytest.raises(SystemExit) as e:
        accuracy_matrix.main(["--preset", preset, "--out", str(out)])
    assert e.value.code == (1 if failing else 0)
    art = json.loads(out.read_text())
    assert list(art) == jax_artifact_keys()
    assert art["preset"] == preset and len(art["rows"]) == 10
    assert art["gates"] == {"ate_cm": 10.0 if preset == "gpu" else 6.0,
                            "ld_err_us": 2.0}
    stdout, stderr = capsys.readouterr()
    assert sum(ln.startswith("| ") and "GT family" not in ln
               for ln in stderr.splitlines()) == 10
    summary = json.loads(stdout.strip().splitlines()[-1])
    assert summary["failed"] == (1 if failing else 0)


def test_matrix_defaults():
    """The card's preset, and an artifact under the git-ignored build/,
    never the JAX tool's ACCURACY.json."""
    args = accuracy_matrix.build_parser().parse_args([])
    assert args.preset == "gpu" and args.duration is None
    assert Path(args.out) == ROOT / "build" / "accuracy_torch.json"


def test_entry_matches_graft_entry():
    """`entry(device="cpu")` on JAX's example arguments (carried over
    with `from_numpy`) equals `__graft_entry__.entry()` under jit, f32,
    3 LM iterations on a noiseless window whose cost falls ~1e7-fold to
    the f32 floor: knots_p within 1e-5 m, the line delay within 1e-9 s,
    the cost within 1e-7 of the starting cost (f32 rounding of its sum);
    the port's own example arguments are JAX's."""
    import __graft_entry__ as g

    fn_j, args_j = g.entry()
    out_j = [np.asarray(x) for x in jax.jit(fn_j)(*args_j)]
    fn, args = entry(device="cpu")
    np_args = jax.tree_util.tree_map(np.asarray, args_j)
    targs = [from_numpy(a) for a in np_args[:5]] + [tensor(np_args[5])]
    for a, b in zip(targs[:5], args[:5]):
        for x, y in zip(a, b):
            assert x.dtype == y.dtype and torch.equal(x, y)
    assert torch.equal(targs[5], args[5])
    knots_p, ld, cost = fn(*targs)
    _, st = lm.solve_window(*targs, *entry_aux(), SolveOptions(max_iters=1))
    assert knots_p.dtype == torch.float32
    np.testing.assert_allclose(knots_p.numpy(), out_j[0], rtol=0, atol=1e-5)
    assert abs(float(ld) - float(out_j[1])) <= 1e-9
    assert abs(float(cost) - float(out_j[2])) <= 1e-7 * float(st.cost0)


def entry_aux():
    """The shared constants and config of `entry()`'s window."""
    from ctrlvio_tpu_torch.sim import tiny

    prob = tiny.tiny_problem(torch.float32, device="cpu")
    return (*prob.aux, prob.cfg)


def test_entry_needs_a_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        entry()
