"""The §IV-C training-data pipeline through the port against the JAX
package: ``repro_torch.data`` against ``repro.data``, and the table
operations the pipeline added to the port.

Every comparison is exact: keys, integer payloads (the token vector
column included), weights (copied, never summed), row counts and row
placement, slot by slot over every rank's full capacity.  One rank runs
in process; eight ranks run the JAX side in a subprocess on 8 host
devices (``XLA_FLAGS`` must be set before jax is imported) and the port
on 8 stacked ranks.  The table operations run the JAX side on p ranks
under ``jax.vmap(axis_name="df")``, as ``tests/test_torch_shuffle.py``
does.  Run as a script (``python tests/test_torch_data_pipeline.py
OUT.npz``) this file is the 8-device JAX side.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, os.pardir, "src")

P8 = 8
#: ``tests/md_scripts/data_pipeline.py``'s corpus
CCFG8 = dict(num_docs=2048, payload_tokens=32, vocab_size=1000,
             dup_rate=0.4, seed=3)
CCFG1 = dict(num_docs=512, payload_tokens=16, vocab_size=300, dup_rate=0.3,
             seed=5)
BATCH, SEQ, N_BATCHES = 4, 16, 3


def _dist_arrays(t):
    """(flat (p * cap, ...) columns, (p,) counts) of a JAX DistTable."""
    return ({k: np.asarray(v) for k, v in t.columns.items()},
            np.asarray(t.row_counts))


def _same_dist(got, want_cols, want_counts):
    cols, counts = got.to_reference()
    np.testing.assert_array_equal(counts, want_counts)
    assert sorted(cols) == sorted(want_cols)
    for k, w in want_cols.items():
        assert cols[k].dtype == w.dtype, k
        np.testing.assert_array_equal(cols[k], w, err_msg=k)


def _batches(table, seed=0):
    from repro_torch.data import batches_from_table
    it = batches_from_table(table, BATCH, SEQ, seed=seed)
    return [next(it) for _ in range(N_BATCHES)]


def _run_port(ccfg, p, target=None):
    from repro_torch.core import CylonExecutor, CylonStore
    from repro_torch.data import (CorpusConfig, preprocess, source_weights,
                                  synth_corpus)
    cfg = CorpusConfig(**ccfg)
    gang = CylonExecutor(parallelism=p, device="cpu")
    store = CylonStore()
    corpus = synth_corpus(cfg, p, device="cpu")
    weights = source_weights(cfg.num_sources, p, device="cpu")
    out = preprocess(gang, corpus, weights, quality_min=0.2, store=store)
    got = store.get("train_corpus", target_parallelism=target)
    return corpus, weights, out, got


# ---------------------------------------------------------------------- #
# One rank, in process
# ---------------------------------------------------------------------- #
def test_pipeline_one_rank_matches_reference():
    from repro.core import CylonExecutor, CylonStore, DevicePool
    from repro.data import (CorpusConfig, batches_from_table, preprocess,
                            source_weights, synth_corpus)
    cfg = CorpusConfig(**CCFG1)
    gang = CylonExecutor(parallelism=1, pool=DevicePool())
    store = CylonStore()
    corpus = synth_corpus(cfg, 1)
    out = preprocess(gang, corpus, source_weights(cfg.num_sources, 1),
                     store=store)
    t_corpus, _, t_out, t_got = _run_port(CCFG1, 1)
    _same_dist(t_corpus, *_dist_arrays(corpus))
    _same_dist(t_out, *_dist_arrays(out))
    assert t_got is t_out                 # same gang size: no re-split
    it = batches_from_table(store.get("train_corpus"), BATCH, SEQ, seed=0)
    for want, got in zip([next(it) for _ in range(N_BATCHES)],
                         _batches(t_got)):
        for k in ("tokens", "labels"):
            assert got[k].dtype == want[k].dtype == np.int32
            np.testing.assert_array_equal(got[k], want[k])


# ---------------------------------------------------------------------- #
# Eight ranks: the JAX side in a subprocess
# ---------------------------------------------------------------------- #
def _reference_main(path):
    """JAX side on 8 host devices: corpus, preprocess, the store's
    re-split to 4 ranks and three batches; writes ``path``."""
    from repro.core import CylonExecutor, CylonStore, DevicePool
    from repro.data import (CorpusConfig, batches_from_table, preprocess,
                            source_weights, synth_corpus)
    cfg = CorpusConfig(**CCFG8)
    gang = CylonExecutor(parallelism=P8, pool=DevicePool())
    assert gang.parallelism == P8
    store = CylonStore()
    corpus = synth_corpus(cfg, P8)
    out = preprocess(gang, corpus, source_weights(cfg.num_sources, P8),
                     store=store)
    got = store.get("train_corpus", target_parallelism=4)
    res = {}
    for tag, t in (("out", out), ("got", got)):
        cols, counts = _dist_arrays(t)
        res.update({f"{tag}/{k}": v for k, v in cols.items()})
        res[f"{tag}/__counts"] = counts
    it = batches_from_table(got, BATCH, SEQ, seed=0)
    for i in range(N_BATCHES):
        for k, v in next(it).items():
            res[f"batch{i}/{k}"] = v
    np.savez(path, **res)


@pytest.fixture(scope="module")
def reference8(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("data8") / "ref.npz")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC),
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), path],
                          capture_output=True, text=True, timeout=600,
                          env=env)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return dict(np.load(path))


def _part(ref, tag):
    cols = {k.split("/")[1]: v for k, v in ref.items()
            if k.startswith(f"{tag}/") and not k.endswith("__counts")}
    return cols, ref[f"{tag}/__counts"]


def test_pipeline_eight_ranks_matches_reference(reference8):
    corpus, weights, out, got = _run_port(CCFG8, P8, target=4)
    _same_dist(out, *_part(reference8, "out"))
    _same_dist(got, *_part(reference8, "got"))
    for i, b in enumerate(_batches(got)):
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(b[k], reference8[f"batch{i}/{k}"])


def test_pipeline_eight_ranks_matches_numpy_oracle():
    # tests/md_scripts/data_pipeline.py's checks, on the port
    corpus, weights, out, got = _run_port(CCFG8, P8, target=4)
    res = out.to_numpy()
    raw = corpus.to_numpy()
    first = {}
    for did, grp in zip(raw["doc_id"], raw["dup_group"]):
        first.setdefault(grp, did)         # doc_id ascends: the min id
    keep = np.asarray([first[g] == d for d, g in
                       zip(raw["doc_id"], raw["dup_group"])])
    keep &= raw["quality"] >= 0.2
    expect_ids = np.sort(raw["doc_id"][keep])
    np.testing.assert_array_equal(np.sort(res["doc_id"]), expect_ids)
    w = weights.to_numpy()
    wmap = dict(zip(w["source"].tolist(), w["weight"].tolist()))
    np.testing.assert_array_equal(
        res["weight"], np.asarray([wmap[s] for s in res["source"].tolist()],
                                  np.float32))
    # each kept document keeps its own payload
    by_id = {d: i for i, d in enumerate(raw["doc_id"].tolist())}
    rows = [by_id[d] for d in res["doc_id"].tolist()]
    np.testing.assert_array_equal(res["tokens"], raw["tokens"][rows])
    counts = out.row_counts.numpy()
    assert counts.sum() == len(expect_ids)
    assert counts.max() <= 2.0 * max(counts.mean(), 1)
    np.testing.assert_array_equal(np.sort(got.to_numpy()["doc_id"]),
                                  expect_ids)
    b = _batches(got)[0]
    assert b["tokens"].shape == b["labels"].shape == (BATCH, SEQ)
    assert (b["tokens"] < CCFG8["vocab_size"]).all()


# ---------------------------------------------------------------------- #
# Table operations the pipeline added (JAX side under vmap)
# ---------------------------------------------------------------------- #
def _ranks(seed, p, cap, width=5, n_keys=40):
    rng = np.random.default_rng(seed)
    cols = {"k": rng.integers(0, n_keys, (p, cap)).astype(np.int32),
            "q": rng.random((p, cap)).astype(np.float32),
            "tok": rng.integers(0, 1000, (p, cap, width)).astype(np.int32)}
    return cols, rng.integers(0, cap + 1, p).astype(np.int32)


def _run_jax(fn, cols, counts):
    import jax
    import jax.numpy as jnp
    from repro.comm import get_communicator
    from repro.dataframe.table import Table
    comm = get_communicator("xla", "df")

    def f(c, n):
        return fn(comm, Table(dict(c), n))
    out = jax.jit(jax.vmap(f, axis_name="df"))(
        {k: jnp.asarray(v) for k, v in cols.items()}, jnp.asarray(counts))
    return jax.tree_util.tree_map(np.asarray, out)


def _run_port_op(fn, cols, counts):
    import torch
    from repro_torch.comm import StackedCommunicator
    from repro_torch.dataframe.table import Table
    t = Table({k: torch.as_tensor(v) for k, v in cols.items()},
              torch.as_tensor(counts))
    return fn(StackedCommunicator(len(counts)), t)


def _same_table(jt, tt):
    np.testing.assert_array_equal(tt.row_count.numpy(),
                                  np.asarray(jt.row_count))
    assert sorted(jt.columns) == sorted(tt.columns)
    for k, a in jt.columns.items():
        b = tt.columns[k].numpy()
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(b, a, err_msg=k)


@pytest.mark.parametrize("p", [1, 4])
def test_filter_rows_and_map_columns_match_reference(p):
    from repro.dataframe import filter_rows as jf
    from repro.dataframe.ops_local import map_columns as jm
    from repro_torch.dataframe import filter_rows as tf, map_columns as tm
    cols, counts = _ranks(11 + p, p, 24)
    want = _run_jax(lambda c, t: jm(jf(t, lambda u: u.col("q") >= 0.4),
                                    lambda v: v * 3 + 1, ["k", "tok"]),
                    cols, counts)
    got = _run_port_op(lambda c, t: tm(tf(t, lambda u: u.col("q") >= 0.4),
                                       lambda v: v * 3 + 1, ["k", "tok"]),
                       cols, counts)
    _same_table(want, got)


@pytest.mark.parametrize("factor,pack", [(1.0, False), (1.0, True),
                                         (4.0, False)])
def test_shuffle_capacity_factor_and_pack_match_reference(factor, pack):
    # three keys over 4 ranks: at factor 1.0 the send buckets drop rows,
    # and the drop counts and the surviving rows' slots must match too
    from repro.dataframe import shuffle as js
    from repro_torch.dataframe import shuffle as ts
    p = 4
    cols, counts = _ranks(3, p, 64, n_keys=3)

    def run(shuffle, c, t):
        out, st = shuffle(t, c, key_cols=["k"], capacity_factor=factor,
                          pack=pack)
        return out, st.send_dropped, st.recv_dropped
    want, j_sd, j_rd = _run_jax(lambda c, t: run(js, c, t), cols, counts)
    got, t_sd, t_rd = _run_port_op(lambda c, t: run(ts, c, t), cols, counts)
    _same_table(want, got)
    np.testing.assert_array_equal(t_sd.numpy(), j_sd)
    np.testing.assert_array_equal(t_rd.numpy(), j_rd)
    if factor == 1.0:
        assert j_sd.sum() > 0


def test_table_from_arrays_vector_columns_match_reference():
    import torch
    from repro.dataframe.table import Table as JT
    from repro_torch.dataframe.table import Table as TT
    rng = np.random.default_rng(7)
    tok = rng.integers(0, 9, (6, 3)).astype(np.int32)
    k = rng.integers(0, 5, 6).astype(np.int32)
    jt = JT.from_arrays({"k": k, "tok": tok}, capacity=8, row_count=5)
    tt = TT.from_arrays({"k": k[None], "tok": tok[None]}, capacity=8,
                        row_count=5, device="cpu")
    assert tt.columns["tok"].shape == (1, 8, 3)
    for name in ("k", "tok"):
        np.testing.assert_array_equal(tt.columns[name][0].numpy(),
                                      np.asarray(jt.columns[name]))
        np.testing.assert_array_equal(tt.to_numpy()[name],
                                      jt.to_numpy()[name])
        np.testing.assert_array_equal(tt.col(name)[0].numpy(),
                                      np.asarray(jt.col(name)))
    je, te = JT.empty_like(jt, capacity=4), TT.empty_like(tt, capacity=4)
    assert int(te.row_count[0]) == int(je.row_count) == 0
    assert te.columns["tok"].shape == (1,) + je.columns["tok"].shape
    jw = jt.with_column("k2", jt.col("k") * 2)
    tw = tt.with_column("k2", tt.col("k") * 2)
    np.testing.assert_array_equal(tw.to_numpy()["k2"], jw.to_numpy()["k2"])
    # stacked ranks: per-rank counts, rows concatenated rank after rank
    two = TT.from_arrays({"tok": torch.as_tensor(np.stack([tok, tok + 10]))},
                         capacity=7, row_count=torch.tensor([2, 6]))
    np.testing.assert_array_equal(two.to_numpy()["tok"],
                                  np.concatenate([tok[:2], tok + 10]))
    with pytest.raises(TypeError):
        TT.from_arrays({"s": np.array([["a"]])}, device="cpu")


def test_dist_table_vector_column_roundtrip():
    from repro.core import DistTable as JD
    from repro_torch.core import DistTable as TD
    rng = np.random.default_rng(9)
    data = {"id": np.arange(13, dtype=np.int32),
            "tok": rng.integers(0, 50, (13, 4)).astype(np.int32)}
    jd = JD.from_numpy(data, 1, capacity=16)
    td = TD.from_numpy(data, 1, capacity=16, device="cpu")
    _same_dist(td, *_dist_arrays(jd))
    for k in data:
        np.testing.assert_array_equal(td.to_numpy()[k], jd.to_numpy()[k])
    t4 = TD.from_numpy(data, 4, device="cpu")
    assert t4.columns["tok"].shape == (4, 8, 4)
    np.testing.assert_array_equal(t4.to_numpy()["tok"], data["tok"])


if __name__ == "__main__":
    _reference_main(sys.argv[1])
