"""The JAX package's ``examples/`` against the port's ``examples/torch/``,
on the CPU.

One subprocess with 8 JAX host devices runs the reference's
``pipeline_ops``, ``legacy_plan_api``, ``planner_explain`` and
``quickstart`` with ``runpy`` and keeps what each prints and its result
tables.  Beside it, two port subprocesses run the ``examples/torch/``
counterparts with ``--device cpu`` (the four dataframe examples in one,
``serve_batch`` at its defaults and ``train_e2e`` at ``--steps 12
--batch 2 --seq 64`` in the other), each example's tables saved by its ``--out``;
afterwards neither holds a ``jax``, ``jaxlib`` or ``repro`` module.

What is deterministic must be equal: every printed line of
``legacy_plan_api`` and ``quickstart`` (EXPLAIN text, row count, joined
rows, drops, the first joined rows), and of ``pipeline_ops`` and
``planner_explain`` with their wall times masked (stage count, per-mode
row counts, both EXPLAIN texts, the planner's stages, shuffles, rows and
bytes shuffled, the examples' own checks).  The result tables: keys,
integer-valued sums and joined rows exactly; sums and means of random
float32 values within rtol 1e-5 (the summation order differs).  Every
port example prints its own check line (``chip_smoke.EXAMPLE_CHECKS``,
which the card run holds too; the tables are compared by
``chip_smoke.same_example_tables``): ``serve_batch``'s greedy decode
equals its full-forward replay, and ``train_e2e`` takes its steps with
finite losses and says "OK: improved" (its last 10 steps' mean loss
under its first 10's by more than 0.5; at 12 steps the two windows
differ in two steps, and the loss falls from step 10 of the warmup on).
Without ``--device`` every port example raises on a machine with no
card.

About 40 s in one worker on an idle 8-core CPU (the three subprocesses
run at once; train_e2e's 12 steps are the longest).

    PYTHONPATH=src JAX_PLATFORMS=cpu python -m pytest -q \\
        tests/test_torch_examples.py
"""

import contextlib
import io
import json
import math
import os
import re
import runpy
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")
sys.path.insert(0, REPO)
try:
    from chip_smoke import (EXAMPLE_CHECKS, example_check_line,
                            same_example_tables)
finally:
    sys.path.remove(REPO)
FRAMES = ("pipeline_ops", "legacy_plan_api", "planner_explain", "quickstart")
MODELS = ("serve_batch", "train_e2e")
#: the port's arguments beside ``--device cpu`` and ``--out``
ARGS = {"train_e2e": ["--steps", "12", "--batch", "2", "--seq", "64"]}
_WALLS = re.compile(r"first=\s*[0-9.]+s cached=\s*[0-9.]+s")
_FLOAT_RTOL = 1e-5


def _tables(name, ns):
    """The reference example's result tables from its namespace, under the
    keys of the port's ``--out`` file."""
    def flat(prefix, d):
        return {f"{prefix}/{c}": np.asarray(v) for c, v in d.items()}
    if name in ("pipeline_ops", "planner_explain"):
        return {k: v for tag, d in ns["results"].items()
                for k, v in flat(tag, d).items()}
    if name == "legacy_plan_api":
        return {**flat("builder", ns["out"]), **flat("frontend", ns["got"])}
    return {**flat("joined", ns["rows"]),
            "dropped": np.asarray(ns["dropped"])}


def _run(path, argv):
    """``path`` as ``__main__`` with ``argv``; what it printed and its
    namespace."""
    buf, old = io.StringIO(), sys.argv
    sys.argv = [path, *argv]
    try:
        with contextlib.redirect_stdout(buf):
            ns = runpy.run_path(path, run_name="__main__")
    finally:
        sys.argv = old
    return buf.getvalue(), ns


def _reference_main(d):
    """JAX side: 8 host devices; ``d/reference.json`` and
    ``d/reference_<name>.npz``."""
    printed = {}
    for name in FRAMES:
        printed[name], ns = _run(os.path.join(REPO, "examples",
                                              f"{name}.py"), [])
        np.savez(os.path.join(d, f"reference_{name}.npz"),
                 **_tables(name, ns))
    with open(os.path.join(d, "reference.json"), "w") as f:
        json.dump(printed, f)


def _port_main(d, tag, names):
    """Port side: ``names`` on the CPU, two threads (more only spin on
    these small operators); ``d/port_<tag>.json`` and ``d/<name>.npz``."""
    import torch
    torch.set_num_threads(2)
    printed = {}
    for name in names:
        printed[name], _ = _run(
            os.path.join(REPO, "examples", "torch", f"{name}.py"),
            ["--device", "cpu", "--out", os.path.join(d, f"{name}.npz"),
             *ARGS.get(name, [])])
    bad = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "jaxlib", "repro"))
    with open(os.path.join(d, f"port_{tag}.json"), "w") as f:
        json.dump({"printed": printed, "bad": bad}, f)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Start the three subprocesses at once; wait for each; its directory
    and what it wrote."""
    d = str(tmp_path_factory.mktemp("examples"))
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    me = os.path.abspath(__file__)
    procs = {tag: subprocess.Popen([sys.executable, me, *argv, d],
                                   stdout=subprocess.PIPE,
                                   stderr=subprocess.STDOUT, text=True,
                                   env=env)
             for tag, argv in (("reference", ["reference"]),
                               ("frames", ["port", "frames"]),
                               ("models", ["port", "models"]))}
    try:
        for tag, proc in procs.items():
            log = proc.communicate(timeout=600)[0]
            assert proc.returncode == 0, f"{tag}: {log[-4000:]}"
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    with open(os.path.join(d, "reference.json")) as f:
        ref = json.load(f)
    port = {}
    for tag in ("frames", "models"):
        with open(os.path.join(d, f"port_{tag}.json")) as f:
            port[tag] = json.load(f)
    return d, ref, port


def _printed(port, name):
    return port["frames" if name in FRAMES else "models"]["printed"][name]


@pytest.mark.parametrize("tag", ("frames", "models"))
def test_port_examples_load_no_jax_or_repro(runs, tag):
    assert runs[2][tag]["bad"] == []


@pytest.mark.parametrize("name", FRAMES)
def test_printed_lines_equal_reference(runs, name):
    # EXPLAIN text, row counts, stages, shuffles, rows / bytes shuffled,
    # joined rows and drops; only the wall times are masked
    _, ref, port = runs
    want = _WALLS.sub("first=* cached=*", ref[name]).splitlines()
    got = _WALLS.sub("first=* cached=*", _printed(port, name)).splitlines()
    assert len(got) == len(want), (got, want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g == w, f"{name} line {i}:\n port      {g!r}\n reference {w!r}"


@pytest.mark.parametrize("name", FRAMES)
def test_result_tables_equal_reference(runs, name):
    d = runs[0]
    want = dict(np.load(os.path.join(d, f"reference_{name}.npz")))
    got = dict(np.load(os.path.join(d, f"{name}.npz")))
    launches = {k for k in got if k.startswith("launches/")}
    assert launches and all(int(got[k]) == 0 for k in launches), \
        "a kernel launched on the CPU"
    same_example_tables(name, got, want, rtol=_FLOAT_RTOL)


@pytest.mark.parametrize("name", sorted(EXAMPLE_CHECKS))
def test_example_checks_pass(runs, name):
    printed = _printed(runs[2], name)
    assert example_check_line(name, printed) is not None, printed


def test_serve_batch_generates_both_runs(runs):
    lines = _printed(runs[2], "serve_batch").splitlines()
    assert lines[0].startswith("greedy: 8x48 tokens in "), lines
    assert lines[1].startswith("sampled: 8x48 tokens in "), lines
    tokens = np.load(os.path.join(runs[0], "serve_batch.npz"))["tokens"]
    assert tokens.shape == (8, 48) and bool(
        np.load(os.path.join(runs[0], "serve_batch.npz"))["replay"])


def test_train_e2e_steps_with_finite_losses(runs):
    lines = _printed(runs[2], "train_e2e").splitlines()
    assert lines[0].startswith("[prep] gang=4 done in "), lines
    assert lines[1] == "[train] params=74.9M mesh={'data': 1, 'model': 1}"
    assert lines[-1].startswith("[result] loss "), lines
    out = np.load(os.path.join(runs[0], "train_e2e.npz"))
    assert out["losses"].shape == (12,) and out["step_s"].shape == (12,)
    assert all(math.isfinite(x) for x in out["losses"]), out["losses"]


def test_examples_raise_without_a_card():
    # --device defaults to cuda: no card, no run on the CPU
    env = dict(os.environ, PYTHONPATH=SRC, CUDA_VISIBLE_DEVICES="")
    procs = {name: subprocess.Popen(
        [sys.executable, os.path.join(REPO, "examples", "torch",
                                      f"{name}.py")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for name in FRAMES + MODELS}
    for name, proc in procs.items():
        out, err = proc.communicate(timeout=300)
        assert proc.returncode != 0 and out == "", name
        assert "no CUDA device is available" in err, (name, err[-2000:])


if __name__ == "__main__":
    if sys.argv[1] == "reference":
        _reference_main(sys.argv[2])
    else:
        _port_main(sys.argv[3], sys.argv[2],
                   FRAMES if sys.argv[2] == "frames" else MODELS)
