"""Fault injection and recovery through the port against the JAX package.

``repro_torch.faults`` is held to ``repro.faults`` on the same inputs:
parsed plans, ``random_plan`` draws, ``RetryPolicy`` backoff and the
``FaultRun`` occurrence streams are equal value for value.  Then one fault
at each of the 11 registered sites runs through both packages' executors
(the JAX package on its one CPU device, the port on one rank on the CPU):
every recovered result is bit-identical to the fault-free run of its own
package and to the JAX package's, with equal ``retries``,
``faults_injected``, ``degraded`` and ``rows_dropped``.  The payloads are
integer-valued float32, so sums are exact and equality is exact.
Deadlines, cancellation, retry exhaustion, the ``REPRO_FAULTS`` plumbing,
session defaults and the stage-cache invariant follow
``tests/test_faults.py``.
"""

import os
import time

import numpy as np
import pytest

from repro import faults as jf
from repro_torch import faults as tf

# ---------------------------------------------------------------------- #
# Plans, backoff and occurrence streams: equal value for value
# ---------------------------------------------------------------------- #
PLAN_TEXTS = [
    "morsel:execute@1x2=raise;spill:*=hang;seed=7",
    "stage:launch=raise",
    "transfer:h2d@*x3=raise",
    "segment:launch@0=corrupt-capacity;build:resident@1=raise",
    "a2a:chunk@2=hang;seed=3",
]


@pytest.mark.parametrize("text", PLAN_TEXTS)
def test_parsed_plans_equal(text):
    want, got = jf.parse_fault_plan(text), tf.parse_fault_plan(text)
    assert str(got) == str(want)
    assert got.seed == want.seed
    assert [(s.site, s.kind, s.at, s.times) for s in got.specs] == \
        [(s.site, s.kind, s.at, s.times) for s in want.specs]


@pytest.mark.parametrize("seed", [0, 1, 7, 123, 2024])
def test_random_plans_equal(seed):
    for kw in ({}, dict(nfaults=3), dict(nfaults=2, max_occurrence=5,
                                         kinds=("raise", "hang"))):
        assert str(tf.random_plan(seed, **kw)) == \
            str(jf.random_plan(seed, **kw))
    assert tf.SITES == jf.SITES and tf.KINDS == jf.KINDS


@pytest.mark.parametrize("seed", [0, 5, 99])
def test_retry_policy_delay_equal(seed):
    for kw in ({}, dict(backoff_s=0.01, backoff_max_s=0.05, jitter=0.25)):
        want = jf.RetryPolicy(seed=seed, **kw)
        got = tf.RetryPolicy(seed=seed, **kw)
        assert [got.delay(a) for a in range(8)] == \
            [want.delay(a) for a in range(8)]
    assert tf.resolve_retry(3) == tf.RetryPolicy(retries=3)
    with pytest.raises(TypeError, match="retries="):
        tf.resolve_retry("3")


def _stream(mod, text, visits):
    """What a ``FaultRun`` of ``text`` does at each of ``visits``:
    ``(site, "ok" | "raise" | capacity)``."""
    run = mod.resolve_faults(text)
    out = []
    for site, cap in visits:
        try:
            if cap is None:
                run.check(site)
                out.append("ok")
            else:
                out.append(run.capacity(site, cap))
        except mod.InjectedFault as e:
            out.append(("raise", e.site))
    return out, run.injected


@pytest.mark.parametrize("text", [
    "morsel:execute@1=raise", "morsel:execute@*x2=raise",
    "segment:launch@1=corrupt-capacity;transfer:*@0=raise",
    "spill:*@1x3=raise;build:resident@0=corrupt-capacity",
])
def test_fault_run_streams_equal(text):
    rng = np.random.default_rng(len(text))
    visits = [(jf.SITES[i], None if i % 3 else int(rng.integers(8, 4096)))
              for i in rng.integers(0, len(jf.SITES), 64)]
    assert _stream(tf, text, visits) == _stream(jf, text, visits)


def test_fault_spec_rejects_unknown_site_and_kind():
    with pytest.raises(ValueError, match="matches no registered site"):
        tf.FaultSpec("no:such:site")
    with pytest.raises(ValueError, match="kind"):
        tf.FaultSpec("morsel:execute", kind="explode")
    with pytest.raises(TypeError, match="faults="):
        tf.resolve_faults(3)
    assert tf.resolve_faults(False) is tf.NULL_FAULTS


# ---------------------------------------------------------------------- #
# Canonical queries, one per executor, run in both packages
# ---------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def envs():
    """(JAX env on its one CPU device, port env of one rank on the CPU)."""
    from repro.core import CylonEnv as JEnv
    from repro_torch.core import CylonEnv as TEnv
    return JEnv(), TEnv(1, device="cpu")


def _morsel_tables():
    """``tests/test_faults.py``'s out-of-core query inputs: a resident
    join build, a streamed filter + join segment and a groupby combine
    (integer-valued payloads, so sums are exact)."""
    n = 96
    return {"l": {"k": (np.arange(n) % 7).astype(np.int32),
                  "v0": (np.arange(n) % 13).astype(np.float32)},
            "r": {"k": np.arange(7, dtype=np.int32),
                  "w": (np.arange(7) * 2.0).astype(np.float32)}}


def _morsel_plan(Plan, col):
    return (Plan.scan("l").filter(col("v0") >= 0.0)
            .join(Plan.scan("r"), on="k")
            .groupby(["k"], {"v0": ["sum"]}))


def _staged_plan(Plan, col):
    return Plan.scan("l").groupby(["k"], {"v0": ["sum", "count"]})


def _staged_tables(DistTable, **kw):
    n = 128
    return {"l": DistTable.from_numpy(
        {"k": (np.arange(n) % 11).astype(np.int32),
         "v0": np.arange(n, dtype=np.float32)}, 1, **kw)}


def _run(pkg, env, case, **kw):
    """``execute`` the canonical ``case`` ("staged" or "morsel") in
    ``pkg`` ("repro" or "repro_torch") with ``kw``; returns
    ``(result as numpy, stats)``."""
    import importlib
    core = importlib.import_module(f"{pkg}.core")
    col = importlib.import_module(f"{pkg}.expr").col
    if case == "staged":
        tables = _staged_tables(core.DistTable, **(
            {"device": "cpu"} if pkg == "repro_torch" else {}))
        out, st = core.execute(_staged_plan(core.Plan, col), env, tables,
                               mode="bsp_staged", collect_stats=True, **kw)
    else:
        out, st = core.execute(_morsel_plan(core.Plan, col), env,
                               _morsel_tables(), morsel_rows=32,
                               collect_stats=True, **kw)
    return out.to_numpy(), st


def _same(got, want):
    assert sorted(got) == sorted(want)
    for c in want:
        assert got[c].dtype == want[c].dtype, c
        np.testing.assert_array_equal(got[c], want[c], err_msg=c)


FAULT_STATS = ("retries", "faults_injected", "degraded", "rows_dropped",
               "morsels", "rows_shuffled")


def _same_stats(got, want, keys=FAULT_STATS):
    assert {k: getattr(got, k) for k in keys} == \
        {k: getattr(want, k) for k in keys}


@pytest.fixture(scope="module")
def clean(envs):
    """Each package's fault-free result of each canonical case."""
    out = {}
    for case in ("staged", "morsel"):
        for pkg, env in zip(("repro", "repro_torch"), envs):
            res, st = _run(pkg, env, case, faults=False)
            assert st.retries == 0 and st.rows_dropped == 0
            out[(pkg, case)] = (res, st)
        _same(out[("repro_torch", case)][0], out[("repro", case)][0])
    return out


def _case_of(site):
    return "staged" if site in ("stage:launch", "a2a:chunk") else "morsel"


@pytest.mark.parametrize("site", tf.SITES)
def test_single_fault_every_site_recovers_like_reference(envs, clean,
                                                         site):
    # one raise at the site's first visit: fired, retried, and the
    # recovered result bit-identical to the fault-free run, in both
    # packages, with equal recovery stats
    case = _case_of(site)
    plan = f"{site}@0=raise"
    want, wst = _run("repro", envs[0], case, faults=plan)
    got, gst = _run("repro_torch", envs[1], case, faults=plan)
    assert gst.faults_injected == 1 and gst.retries == 1, site
    _same_stats(gst, wst)
    _same(got, want)
    _same(got, clean[("repro_torch", case)][0])


@pytest.mark.parametrize("site", ["build:resident", "segment:launch"])
def test_corrupt_capacity_degrades_like_reference(envs, clean, site):
    # a corrupted capacity drops rows on the first attempt; the degrade
    # loop (the tuner, at the default adaptive) replays until every row
    # is back, with the reference's replay count
    plan = f"{site}@0=corrupt-capacity"
    want, wst = _run("repro", envs[0], "morsel", faults=plan)
    got, gst = _run("repro_torch", envs[1], "morsel", faults=plan)
    _same_stats(gst, wst, FAULT_STATS + ("autotune_steps",))
    assert gst.rows_dropped == 0 and gst.faults_injected == 1
    _same(got, want)
    np.testing.assert_array_equal(got["k"],
                                  clean[("repro_torch", "morsel")][0]["k"])


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_random_plans_recover_like_reference(envs, clean, seed):
    plan = tf.random_plan(seed, nfaults=2, max_occurrence=2)
    jplan = jf.random_plan(seed, nfaults=2, max_occurrence=2)
    for case in ("staged", "morsel"):
        want, wst = _run("repro", envs[0], case, faults=jplan)
        got, gst = _run("repro_torch", envs[1], case, faults=plan)
        _same_stats(gst, wst)
        assert gst.retries == gst.faults_injected
        _same(got, want)
        _same(got, clean[("repro_torch", case)][0])


def test_fault_on_last_morsel(envs, clean):
    # a faulted last morsel discards the attempt's nearly complete output
    # spill and rebuilds it, not re-appends it
    last = clean[("repro_torch", "morsel")][1].morsels - 1
    got, gst = _run("repro_torch", envs[1], "morsel",
                    faults=f"morsel:execute@{last}=raise")
    assert gst.faults_injected == 1 and gst.retries == 1
    _same(got, clean[("repro_torch", "morsel")][0])


def test_hang_under_timeout_then_clean_run(envs, clean):
    # a hang is fenced by the deadline (QueryTimeout within deadline + 1 s)
    # and leaves the env as it was: the next fault-free run on it is
    # bit-identical
    plan = tf.FaultPlan((tf.FaultSpec("morsel:execute", kind="hang", at=1),),
                        hang_s=30.0)
    t0 = time.monotonic()
    with pytest.raises(tf.QueryTimeout):
        _run("repro_torch", envs[1], "morsel", faults=plan, timeout=0.3)
    assert time.monotonic() - t0 < 0.3 + 1.0
    got, gst = _run("repro_torch", envs[1], "morsel", faults=False)
    _same(got, clean[("repro_torch", "morsel")][0])
    assert gst.cache_misses == 0


def test_hang_expires_and_is_retried(envs, clean):
    plan = tf.FaultPlan((tf.FaultSpec("morsel:execute", kind="hang", at=1),),
                        hang_s=0.05)
    got, gst = _run("repro_torch", envs[1], "morsel", faults=plan)
    assert gst.retries == 1
    _same(got, clean[("repro_torch", "morsel")][0])


def test_timeout_mid_backoff(envs):
    plan = tf.FaultPlan((tf.FaultSpec("stage:launch", kind="raise", at=0,
                                      times=99),))
    pol = tf.RetryPolicy(retries=50, backoff_s=0.5, backoff_max_s=0.5)
    t0 = time.monotonic()
    with pytest.raises(tf.QueryTimeout):
        _run("repro_torch", envs[1], "staged", faults=plan, retries=pol,
             timeout=0.3)
    assert time.monotonic() - t0 < 2.0


def test_cancellation_and_exhausted_retries(envs):
    tok = tf.CancellationToken()
    tok.cancel("shed load")
    with pytest.raises(tf.QueryCancelled, match="shed load"):
        _run("repro_torch", envs[1], "staged", timeout=tok)
    child = tf.CancellationToken(parent=tf.CancellationToken())
    child.parent.cancel("parent")
    with pytest.raises(tf.QueryCancelled, match="parent"):
        child.check()
    plan = tf.FaultPlan((tf.FaultSpec("stage:launch", kind="raise",
                                      at=None, times=99),))
    with pytest.raises(tf.InjectedFault):
        _run("repro_torch", envs[1], "staged", faults=plan,
             retries=tf.RetryPolicy(retries=2, backoff_s=0.001))


def test_repro_faults_flag_and_env_var(envs, clean, monkeypatch):
    from repro_torch import flags
    with flags.fault_injection("stage:launch@0=raise"):
        got, gst = _run("repro_torch", envs[1], "staged")
    assert gst.faults_injected == 1 and gst.retries == 1
    _same(got, clean[("repro_torch", "staged")][0])
    monkeypatch.setenv("REPRO_FAULTS", "morsel:execute@2=raise")
    got, gst = _run("repro_torch", envs[1], "morsel")
    assert gst.faults_injected == 1
    _same(got, clean[("repro_torch", "morsel")][0])
    monkeypatch.setenv("REPRO_FAULTS", "0")
    assert tf.resolve_faults(None) is tf.NULL_FAULTS
    # an explicit argument beats the variable and the flag
    with flags.fault_injection("stage:launch@0=raise"):
        _, gst = _run("repro_torch", envs[1], "staged", faults=False)
    assert gst.faults_injected == 0


def test_session_level_defaults():
    import repro_torch.df as tdf
    n = 64
    data = {"k": (np.arange(n) % 5).astype(np.int32),
            "v": np.ones(n, np.float32)}
    with tdf.session(parallelism=1, device="cpu",
                     faults="stage:launch@0=raise", retries=3) as env:
        df = tdf.read_numpy(data, env=env)
        _, st = df.groupby("k").agg(v="sum").collect(
            mode="bsp_staged", collect_stats=True)
        assert st.faults_injected == 1 and st.retries == 1
        # an explicit per-call argument overrides the session default
        _, st2 = df.groupby("k").agg(v="sum").collect(
            mode="bsp_staged", collect_stats=True, faults=False)
        assert st2.faults_injected == 0


def test_h2d_fault_replays_from_checkpoint(envs, clean):
    # the staging of a morsel (MorselSource) is a site of its own: a fault
    # there unwinds the segment mid-iteration and the replay builds a new
    # source from the segment's checkpoint
    from repro_torch.core import MorselSource, SpillTable
    plan = tf.resolve_faults("transfer:h2d@1=raise")
    src = MorselSource(SpillTable.from_numpy(_morsel_tables()["l"], 1), 32,
                       envs[1], faults=plan)
    with pytest.raises(tf.InjectedFault, match="transfer:h2d"):
        list(src)
    got, gst = _run("repro_torch", envs[1], "morsel",
                    faults="transfer:h2d@2=raise")
    assert gst.retries == 1
    _same(got, clean[("repro_torch", "morsel")][0])


def test_injection_disabled_builds_nothing_new(envs, clean):
    env = envs[1]
    keys0, m0 = set(env._cache), env.cache_misses
    for kw in ({}, {"retries": 5, "timeout": 60.0, "faults": False,
                    "overflow": "degrade"}):
        for case in ("staged", "morsel"):
            _, st = _run("repro_torch", env, case, **kw)
            assert st.cache_misses == 0
    assert set(env._cache) == keys0 and env.cache_misses == m0


def test_overflow_policy_validation(envs):
    with pytest.raises(ValueError, match="overflow"):
        _run("repro_torch", envs[1], "staged", overflow="explode")
    assert tf.OverflowPolicy.ALL == jf.OverflowPolicy.ALL


def test_faults_module_imports_no_jax():
    import subprocess
    import sys
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       os.pardir, "src")
    code = ("import sys, repro_torch.faults, repro_torch.flags, "
            "repro_torch.adapt; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'repro.')) or m == 'repro']; "
            "print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=dict(os.environ, PYTHONPATH=src),
                          timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
