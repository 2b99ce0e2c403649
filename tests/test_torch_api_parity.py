"""The port's public surface against the JAX package's: every ``__all__``.

For each module of ``src/repro`` that declares an ``__all__`` (its
packages, and the modules that name their own exports), every name there
must import from the ``repro_torch`` module of the same path, and every
parameter of an exported callable (a class: its constructor) must be a
parameter of the port's counterpart.  Both checks skip only the entries
of ``BY_DESIGN``, each a ``(module, name[, parameter])`` with its reason:
the port's by-design differences (README, "The PyTorch/CUDA port").  An
entry that no longer marks a difference fails as well, so the table
stays exact, and the table may hold no entry for ``session`` and none
that exempts a name the port re-exports since ROADMAP item 14.  One more
case imports those names in a fresh interpreter: neither ``jax`` nor
``repro`` is imported, nor ``launch/dryrun.py``, and no process group is
made.

About 7 s in one worker: 3.5 s importing the JAX package's modules (less
where an earlier file of the worker imported JAX) and 3 s starting the
one interpreter.
"""

import importlib
import inspect
import os
import re
import subprocess
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.abspath(os.path.join(HERE, os.pardir, "src"))

_AXIS = ("no mesh axis name: ranks are stacked on a leading axis or are "
         "the processes of a group")
_TPU = "a TPU tiling, interpret or backend switch: no Hopper meaning"
_PALLAS = ("a Pallas or jnp implementation: the CUDA kernel and its plain "
           "version take its place")

#: (module, name) or (module, name, parameter) -> why the port differs
BY_DESIGN = {
    ("repro.comm", "XlaCommunicator"):
        "the port's 'xla' is comm/stacked.py::StackedCommunicator",
    ("repro.comm", "Communicator", "axis"): _AXIS,
    ("repro.comm", "RingCommunicator", "axis"): _AXIS,
    ("repro.comm", "BruckCommunicator", "axis"): _AXIS,
    ("repro.comm", "get_communicator", "axis"): _AXIS,
    ("repro.core", "AXIS"): _AXIS,
    ("repro.core", "CylonEnv", "axis"): _AXIS,
    ("repro.core", "CylonExecutor", "axis"): _AXIS,
    ("repro.core", "EnvContext", "axis"): _AXIS,
    ("repro.kernels", "radix_partition_xla"): _PALLAS,
    ("repro.kernels", "ssd_scan_chunked_jnp"): _PALLAS,
    ("repro.kernels.flash_attention", "flash_attention_pallas"): _PALLAS,
    ("repro.kernels.radix_partition", "radix_partition_pallas"): _PALLAS,
    ("repro.kernels.radix_partition", "radix_partition_xla"): _PALLAS,
    ("repro.kernels.segmented_reduce", "segmented_sum_pallas"): _PALLAS,
    ("repro.kernels.ssd_scan", "ssd_scan_pallas"): _PALLAS,
    ("repro.kernels.ssd_scan", "ssd_scan_chunked_jnp"): _PALLAS,
    ("repro.launch", "make_local_mesh", "parallelism"):
        "a process group fixes the world size",
    ("repro.obs", "stage_table", "parallelism"):
        "becomes peaks=: the bounds are the card's own",
    ("repro.obs.analyze", "stage_table", "parallelism"):
        "becomes peaks=: the bounds are the card's own",
    ("repro.serve", "ServeEngine", "params"):
        "params= becomes model= (an nn.Module)",
    ("repro.train", "init_train_state", "key"):
        "a seed's key= becomes gen= / device=",
}
#: each kernel's switches, exported from ``repro.kernels`` and its package
_SWITCHES = {
    ("radix_partition", "radix_partition"):
        ("block_rows", "use_kernel", "interpret", "impl"),
    ("segmented_reduce", "segmented_sum"):
        ("block_rows", "block_segments", "use_kernel", "interpret"),
    ("flash_attention", "flash_attention"):
        ("block_q", "block_k", "use_kernel", "interpret"),
    ("ssd_scan", "ssd_scan"): ("use_kernel", "interpret"),
}
for (_pkg, _fn), _params in _SWITCHES.items():
    for _home in ("repro.kernels", f"repro.kernels.{_pkg}"):
        for _p in _params:
            BY_DESIGN[(_home, _fn, _p)] = _TPU

#: ROADMAP item 14's re-exports, and the one keyword it added
ITEM_14 = {"repro.dataframe": ("decode_codes", "encode_strings",
                               "merge_dictionaries", "recode_mapping"),
           "repro.models": ("NO_SHARDING", "ShardingRules"),
           "repro.launch": ("make_local_mesh", "rules_for_mesh")}


def _modules_with_all():
    """Every module of the JAX package whose source assigns ``__all__``,
    found without importing any."""
    root = os.path.join(SRC, "repro")
    out = []
    for d, _, files in os.walk(root):
        for f in files:
            if not f.endswith(".py"):
                continue
            with open(os.path.join(d, f), encoding="utf-8") as fh:
                if not re.search(r"^__all__\s*=", fh.read(), re.M):
                    continue
            rel = os.path.relpath(os.path.join(d, f[:-3]), SRC)
            parts = rel.split(os.sep)
            if parts[-1] == "__init__":
                parts.pop()
            out.append(".".join(parts))
    return sorted(out)


MODULES = _modules_with_all()


def _signature(obj):
    try:
        return inspect.signature(obj)
    except (TypeError, ValueError):
        return None


def test_every_reference_package_is_walked():
    pkgs = {m for m in MODULES
            if os.path.isfile(os.path.join(SRC, *m.split("."),
                                           "__init__.py"))}
    assert {"repro.dataframe", "repro.df", "repro.launch", "repro.models",
            "repro.kernels.ssd_scan"} <= pkgs
    assert {m for m, *_ in BY_DESIGN} <= set(MODULES)


@pytest.mark.parametrize("module", MODULES)
def test_reference_exports_import_from_the_port(module):
    ref = importlib.import_module(module)
    port = importlib.import_module("repro_torch" + module[len("repro"):])
    missing, params = [], []
    for name in ref.__all__:
        if (module, name) in BY_DESIGN:
            assert not hasattr(port, name), \
                f"{module}.{name} is in BY_DESIGN but the port exports it"
            continue
        if not hasattr(port, name):
            missing.append(name)
            continue
        r, t = getattr(ref, name), getattr(port, name)
        if not callable(r):
            continue
        rs, ts = _signature(r), _signature(t)
        if rs is None:
            continue
        assert ts is not None, f"{module}.{name}: the port's has no signature"
        for p in rs.parameters:
            if (module, name, p) in BY_DESIGN:
                assert p not in ts.parameters, \
                    f"{module}.{name}({p}=) is in BY_DESIGN but the port " \
                    f"takes it"
            elif p not in ts.parameters:
                params.append(f"{name}({p}=)")
    assert not missing, f"{module}: the port lacks {missing}"
    assert not params, f"{module}: the port's signatures lack {params}"
    # every entry of this module names an export and, for a parameter, a
    # parameter of the reference's signature
    for key in BY_DESIGN:
        if key[0] == module:
            assert key[1] in ref.__all__, key
            if len(key) == 3:
                assert key[2] in _signature(getattr(ref, key[1])).parameters


def test_by_design_table_exempts_no_closed_gap():
    for key, reason in BY_DESIGN.items():
        assert reason, key
        assert key[1] != "session", key
        assert not (len(key) == 2 and key[1] in ITEM_14.get(key[0], ())), key


def test_item_14_names_import_without_jax_or_a_process_group():
    code = (
        "import sys\n"
        "import torch.distributed as dist\n"
        "from repro_torch.dataframe import (encode_strings, decode_codes,\n"
        "    merge_dictionaries, recode_mapping)\n"
        "from repro_torch.models import ShardingRules, NO_SHARDING\n"
        "from repro_torch.launch import make_local_mesh, rules_for_mesh\n"
        "import repro_torch.df as rdf\n"
        "assert 'devices' in __import__('inspect').signature(\n"
        "    rdf.session).parameters\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'repro'))\n"
        "assert not bad, bad\n"
        "assert 'repro_torch.launch.dryrun' not in sys.modules\n"
        "assert not dist.is_initialized()\n"
        "print('OK')\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120,
                          env=dict(os.environ, PYTHONPATH=SRC))
    assert proc.returncode == 0 and proc.stdout.startswith("OK"), \
        proc.stderr[-2000:]
