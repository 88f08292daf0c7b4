"""The port's serve-path tools on a short CPU capture of the streaming
state (`profile_serve.capture_state`): `ne_ab`'s dense and chunked
normal equations (the same equations), `profile_serve`'s op table and
the trace it writes under `--logdir` (counterparts of `tools/ne_ab.py`
and `tools/profile_serve.py`); and the flags of the port's tools and
command line against the JAX package's."""

import argparse
import importlib.util
import json
import os
import tempfile
import time
from pathlib import Path
from unittest import mock

import pytest
import torch

from ctrlvio_tpu_torch import __main__ as cli
from ctrlvio_tpu_torch.estimator import stream
from ctrlvio_tpu_torch.solver import lm
from ctrlvio_tpu_torch.tools import accuracy_matrix, ne_ab, profile_serve
from tests.torch_parity import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def captured():
    """A short streaming capture on the CPU (2.5 s, 4 warmup frames)."""
    return profile_serve.capture_state(duration=2.5, warmup=4, device="cpu")


def test_ne_ab_dense_equals_chunked(captured):
    """`ne_ab` at B = 1, dense against chunked (all factors in one chunk):
    at the captured state and blob both build the same normal equations
    (within 1e-5 of each block's largest entry: f32 summation order) and
    cost; after the megastep's 12 LM iterations the starting and final
    costs agree within 1e-5 of the starting cost."""
    vio, st, blob = captured
    results, outs = ne_ab.run(vio, st, blob, [1], ["dense", "chunked"], [0],
                              ["chol"], reps=1, warm=0)
    assert [r["variant"] for r in results] == ["dense/chol", "chunked/chol"]
    assert all(r["ms_per_step"] > 0 and r["B"] == 1 for r in results)
    sums = [stream.unpack_summary(outs[(t, 1)][1][0].double().numpy(),
                                  vio.wc)
            for t in ("dense/chol", "chunked/chol")]
    c0 = sums[1]["cost0"]
    assert abs(sums[0]["cost0"] - c0) <= 1e-5 * c0
    assert abs(sums[0]["cost"] - sums[1]["cost"]) <= 1e-5 * c0
    assert all(s["cost"] <= s["cost0"] for s in sums)

    img, imu, bias, fixed = stream.unpack_stream_blob(
        torch.as_tensor(blob), vio.wc, torch.float32)[:4]
    consts = (vio._ext, vio._gravity_j, vio._imu_info, vio._sqrt_info_img)
    ne = {}
    for mode in ("dense", "chunked"):
        _, _, ne_at = lm._setup(st.params, img, imu, bias, st.prior, fixed,
                                *consts, vio.wc, vio._ba_opts, mode, None)
        ne[mode] = ne_at(st.params)
    (eq_d, cost_d), (eq_c, cost_c) = ne["dense"], ne["chunked"]
    for a, b in zip(eq_d, eq_c):
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())
    assert abs(float(cost_d) - float(cost_c)) <= 1e-5 * float(cost_c)


def test_profile_serve_op_table_on_cpu(captured):
    """`op_table` over one batched megastep at B = 1 on the CPU: the ops'
    self host times, sorted by time, every count > 0, thousands of ops,
    their sum within the traced step's wall time (self times do not
    overlap on one thread)."""
    vio, st, blob = captured
    mega = profile_serve.lane_megastep(vio)
    s, blobs, consts = profile_serve.batched_inputs(vio, st, blob, 1)
    t0 = time.perf_counter()
    rows = profile_serve.op_table(mega, s, blobs, consts, 1, vio.device)
    wall_ms = (time.perf_counter() - t0) * 1e3
    ms = [r[1] for r in rows]
    assert ms == sorted(ms, reverse=True) and ms[-1] >= 0
    assert all(r[2] > 0 for r in rows)
    assert sum(r[2] for r in rows) > 1000
    assert any(r[0] == "aten::mm" or r[0] == "aten::bmm" for r in rows)
    assert 0 < sum(ms) <= wall_ms


def test_batched_lanes_take_their_normal_equations(monkeypatch):
    """`VIOConfig.ne_mode` and `ne_chunk` reach the batched megastep that
    BatchedStream builds (as they reach the solo megastep and the
    synchronous solve), as `CTRLVIO_NE` / `_NE_CHUNK` reach every solve in
    the JAX package."""
    from ctrlvio_tpu_torch.bench import BENCH_WINDOW
    from ctrlvio_tpu_torch.estimator.odometry import CtrlVIO, VIOConfig
    from ctrlvio_tpu_torch.parallel import stream_batch

    seen = {}
    real = stream_batch.batched_megastep

    def spy(cfg, opts, caps=None, ne_mode="chunked", chunk=None):
        seen.update(ne_mode=ne_mode, chunk=chunk)
        return real(cfg, opts, caps, ne_mode, chunk)

    monkeypatch.setattr(stream_batch, "batched_megastep", spy)
    cfg = VIOConfig(window_config=BENCH_WINDOW, stream=True, ne_mode="dense",
                    ne_chunk=128)
    vios = [CtrlVIO(cfg, [1.0, 0.0, 0.0, 0.0], [0.0, 0.0, 0.0],
                    device="cpu") for _ in range(2)]
    stream_batch.BatchedStream(vios)
    assert seen == {"ne_mode": "dense", "chunk": 128}


def test_profile_serve_writes_a_trace(captured, tmp_path, monkeypatch,
                                      capsys):
    """`python -m ctrlvio_tpu_torch.tools.profile_serve --logdir DIR` on the
    CPU (the capture stubbed with the module's): the traced step's Chrome
    trace lands under DIR, its path on stderr and in the JSON line, and
    loads as JSON with thousands of events."""
    monkeypatch.setattr(profile_serve, "capture_state",
                        lambda device: captured)
    logdir = tmp_path / "trace"
    profile_serve.main(["--device", "cpu", "--batch", "1", "--reps", "1",
                        "--top", "5", "--logdir", str(logdir)])
    out, err = capsys.readouterr()
    rec = json.loads(out.strip().splitlines()[-1])
    path = Path(rec["trace"])
    assert path.parent == logdir and path.name.endswith(".pt.trace.json")
    assert f"trace written to {path}" in err
    trace = json.loads(path.read_text())
    events = [e for e in trace["traceEvents"] if e.get("ph") == "X"]
    assert len(events) > 1000
    assert rec["B"] == 1 and rec["ops_per_step"] > 1000


class _Parsed(Exception):
    pass


def parser_of(main, *args):
    """The parser `main` builds, taken at its parse_args call."""
    got = {}

    def grab(self, *a, **k):
        got["parser"] = self
        raise _Parsed

    with mock.patch.object(argparse.ArgumentParser, "parse_args", grab):
        with pytest.raises(_Parsed):
            main(*args)
    return got["parser"]


def jax_main(rel):
    """`main` of the JAX package's tool at `rel` (its own directory on the
    path, as when run as a script)."""
    path = ROOT / rel
    spec = importlib.util.spec_from_file_location(
        "jax_" + path.stem, path)
    mod = importlib.util.module_from_spec(spec)
    with mock.patch("sys.path", [str(path.parent)] + __import__("sys").path):
        spec.loader.exec_module(mod)
    return mod.main


def flags(ap):
    """{(subcommand, option): (dest, choices, default, type, nargs,
    const)}, a preset's `tpu` read as `gpu`."""
    gpu = (lambda x: tuple(gpu(v) for v in x) if isinstance(x, (list, tuple))
           else "gpu" if x == "tpu" else x)
    out = {}

    def walk(p, sub):
        for a in p._actions:
            if isinstance(a, argparse._SubParsersAction):
                for name, sp in a.choices.items():
                    walk(sp, name)
            elif a.dest != "help":
                key = a.option_strings[-1] if a.option_strings else a.dest
                out[(sub, key)] = (a.dest, gpu(a.choices), gpu(a.default),
                                   a.type, a.nargs, a.const)

    walk(ap, None)
    return out


def _jax_cli_main(argv=None):
    from ctrlvio_tpu.__main__ import main

    return main(argv)


# (JAX main, port main, the port's own flags, flags whose default is a path
# that the port puts elsewhere)
TOOLS = {
    "profile_serve": (lambda: jax_main("tools/profile_serve.py"),
                      profile_serve.main, {(None, "--device")},
                      {(None, "--logdir")}),
    "ne_ab": (lambda: jax_main("tools/ne_ab.py"), ne_ab.main,
              {(None, "--device")}, set()),
    "accuracy_matrix": (lambda: jax_main("tools/accuracy_matrix.py"),
                        accuracy_matrix.main, set(), {(None, "--out")}),
    "cli": (lambda: _jax_cli_main, cli.main,
            {("run", "--device"), ("run", "--check-syncs")}, set()),
}


@pytest.mark.parametrize("name", sorted(TOOLS))
def test_tool_flags_are_the_jax_packages(name):
    """Every flag of the JAX package's tool or command line, with its
    dest, choices, default, type and arity, plus the port's `--device`
    (and `run --check-syncs`) and nothing else; a path default may point
    elsewhere (the port writes under build/ and the temporary
    directory)."""
    ref_main, port_main, extra, paths = TOOLS[name]
    main = ref_main()
    ref = flags(parser_of(main) if name != "cli" else parser_of(main, []))
    got = flags(parser_of(port_main, []))
    assert set(got) - set(ref) == extra
    assert set(ref) <= set(got)
    for k in ref:
        if k in paths:
            assert isinstance(got[k][2], str)
            assert got[k][:2] + got[k][3:] == ref[k][:2] + ref[k][3:]
        else:
            assert got[k] == ref[k], (k, ref[k], got[k])


def test_profile_serve_logdir_default():
    """The JAX tool's `/tmp/ctrlvio_serve_trace`, under the temporary
    directory the environment names (`/tmp` when it names none)."""
    ref = flags(parser_of(jax_main("tools/profile_serve.py")))
    got = flags(parser_of(profile_serve.main, []))
    assert ref[(None, "--logdir")][2] == "/tmp/ctrlvio_serve_trace"
    assert got[(None, "--logdir")][2] == os.path.join(
        tempfile.gettempdir(), "ctrlvio_serve_trace")
