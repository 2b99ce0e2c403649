"""The JAX package's executable documentation, run through the port.

Every fenced ```python block of ``README.md`` and ``docs/*.md`` runs with
the conventions of ``tests/test_docs_snippets.py``: the blocks of one file
in order in one namespace, seeded with the same preamble (``rdf`` is
``repro_torch.df``), against a fresh default env that is reset afterwards.
The snippet text has ``repro`` as a word rewritten to ``repro_torch``; the
docs themselves are not edited.

On the CPU the default env is ``CylonEnv(device="cpu")``, and a device left
unnamed (``resolve_device(None)``, the card in the port) is the CPU, as the
JAX package's default devices are the host's there.  The ``gpu`` variant
runs the same files with the port's own default, the card: there every
documented shuffle and groupby sum goes through the radix-partition and
segmented-sum kernels.  Only the blocks in ``SKIPPED`` are left out, each
with its reason, and each must still raise its named error, so the list
cannot go stale.

About 2 s in one worker on the CPU; the ``gpu`` variant skips without a
card.  On the card (it imports no JAX):

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_docs_snippets.py
"""

import os
import re

import numpy as np
import pytest
import torch

pd = pytest.importorskip("pandas")

import repro_torch.df as rdf  # noqa: E402
from repro_torch.core import CylonEnv  # noqa: E402

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
_FENCE = re.compile(r"^```python\s*$(.*?)^```\s*$", re.M | re.S)
_REPRO = re.compile(r"\brepro\b")        # not repro_torch: "_" is a word char

#: (file, block) -> (where it is skipped, the error it raises, why)
SKIPPED = {
    ("docs/data_model.md", 0): (
        ("cpu", "cuda"), ValueError, "expected 2, got 1",
        "Table.from_arrays takes stacked (p, n) columns, not one rank's "
        "(n,)"),
    ("docs/observability.md", 1): (
        ("cpu",), ValueError, "no roofline peaks for device 'cpu'",
        "the port's roofline bounds are the card's own"),
}


def _doc_files():
    files = [os.path.join(REPO, "README.md")]
    docs = os.path.join(REPO, "docs")
    if os.path.isdir(docs):
        files += sorted(os.path.join(docs, f) for f in os.listdir(docs)
                        if f.endswith(".md"))
    return files


def _blocks(path):
    with open(path, encoding="utf-8") as f:
        text = f.read()
    return [_REPRO.sub("repro_torch", m.group(1))
            for m in _FENCE.finditer(text)]


def _preamble():
    """``tests/test_docs_snippets.py::_preamble`` with the port's ``rdf``."""
    rng = np.random.default_rng(0)
    return {
        "np": np,
        "pd": pd,
        "rdf": rdf,
        "rng": rng,
        "keys": rng.integers(0, 29, 128).astype(np.int32),
        "vals": rng.integers(0, 8, 128).astype(np.float32),
        "names": rng.choice(np.array(["ash", "birch", "cedar", "oak"]), 128),
    }


FILES = _doc_files()
IDS = [os.path.relpath(f, REPO) for f in FILES]


def _swap_resolve_device(old, new):
    """Put ``new`` where any loaded module of the port holds ``old``."""
    import sys
    for mod in list(sys.modules.values()):
        if (getattr(mod, "__name__", "").startswith("repro_torch")
                and getattr(mod, "resolve_device", None) is old):
            mod.resolve_device = new


@pytest.fixture
def cpu_default():
    """An unnamed device is the CPU while the test runs: a module imported
    meanwhile takes the wrapper from ``core.env``, so every module holding
    it gets the original back afterwards."""
    import repro_torch.core.env as env_mod
    orig = env_mod.resolve_device

    def resolve_device(device=None):
        return orig("cpu" if device is None else device)
    _swap_resolve_device(orig, resolve_device)
    try:
        yield "cpu"
    finally:
        _swap_resolve_device(resolve_device, orig)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


def _run(path, device):
    """Run ``path``'s blocks on a fresh default env on ``device``; return
    the skipped blocks' indices."""
    rel = os.path.relpath(path, REPO)
    blocks = _blocks(path)
    rdf.set_default_env(CylonEnv(device=device))
    ns = _preamble()
    skipped = []
    try:
        for i, block in enumerate(blocks):
            code = compile(block, f"{rel}[snippet {i}]", "exec")
            skip = SKIPPED.get((rel, i))
            if skip is not None and device in skip[0]:
                with pytest.raises(skip[1], match=re.escape(skip[2])):
                    exec(code, dict(ns))  # noqa: S102
                skipped.append(i)
                continue
            exec(code, ns)  # noqa: S102 - executing the docs is the point
    finally:
        rdf.reset_default_env()
    return skipped


def test_docs_have_snippets_and_skips_name_real_blocks():
    assert any(_blocks(f) for f in FILES), "no python snippets found"
    for (rel, i) in SKIPPED:
        assert i < len(_blocks(os.path.join(REPO, rel))), rel


@pytest.mark.parametrize("path", FILES, ids=IDS)
def test_docs_snippets_execute_through_the_port(cpu_default, path):
    rel = os.path.relpath(path, REPO)
    assert _run(path, cpu_default) == [i for (f, i) in SKIPPED if f == rel]


@pytest.mark.gpu
@pytest.mark.parametrize("path", FILES, ids=IDS)
def test_docs_snippets_execute_through_the_port_on_card(cuda, path):
    from repro_torch.kernels import (radix_partition_cuda,
                                     reset_launches, segmented_sum_cuda)
    rel = os.path.relpath(path, REPO)
    reset_launches()
    assert _run(path, cuda) == [i for (f, i), s in SKIPPED.items()
                                if f == rel and cuda in s[0]]
    if rel == "README.md":
        # its pipelines shuffle and sum groups through documented calls
        assert radix_partition_cuda.launches > 0
        assert segmented_sum_cuda.launches > 0
