"""The port's lock witness (``faults/lockwitness.py``) against the JAX
package's, and the port's planes under it, on the CPU.

- JAX's ``tests/test_lockwitness.py``, ported: off mode returns plain
  ``threading`` primitives, a seeded inversion is witnessed (also when the
  acquire times out), a consistent order is not, bare accesses to guarded
  dicts, sets and lists are stamped with the caller's site, a
  ``Condition.wait`` keeps the held stack true, the per-pid dump, and the
  process soak's collectors.
- The same seeded scenarios through both packages' witnesses give equal
  reports, and the collectors of both packages read one directory of a
  JAX-written and a port-written dump to equal summaries.
- With the witness off the port's broker, aggregator and coordinators hold
  plain ``threading`` locks and bare structures.
- With it on, a flat asynchronous federation, the asynchronous tree with
  an aggregator stopped mid-run and a synchronous tree round (the
  ``CoordinatorCore``'s ``_aggs``) run with lock traffic, no inversion and
  no unguarded access.

Every wait has its own timeout in code (no pytest-timeout here).
"""

import json
import os
import threading
import time

import pytest
import torch

from colearn_federated_learning_tpu.faults import lockwitness as jax_lw
from colearn_federated_learning_tpu.faults import procsoak as jax_procsoak
from colearn_federated_learning_tpu_torch.faults import lockwitness, procsoak

_PLAIN_LOCK = type(threading.Lock())
_PLAIN_RLOCK = type(threading.RLock())


@pytest.fixture
def witness_on(monkeypatch):
    monkeypatch.setenv("COLEARN_LOCK_WITNESS", "1")
    monkeypatch.delenv("COLEARN_LOCK_WITNESS_DIR", raising=False)
    for lw in (lockwitness, jax_lw):
        lw.reset()
    yield
    for lw in (lockwitness, jax_lw):
        lw.reset()


# ----------------------------------------------------------------- off --
def test_off_mode_returns_plain_primitives(monkeypatch):
    monkeypatch.delenv("COLEARN_LOCK_WITNESS", raising=False)
    assert not isinstance(lockwitness.lock("x"), lockwitness.WitnessLock)
    obj = {"a": 1}
    assert lockwitness.guarded(obj, "t", lockwitness.lock("x")) is obj
    assert lockwitness.report() == {"enabled": False}


@pytest.mark.parametrize("value", [None, "", "0", "off", "no"])
def test_off_mode_factories_are_threading_s_own(monkeypatch, value):
    if value is None:
        monkeypatch.delenv("COLEARN_LOCK_WITNESS", raising=False)
    else:
        monkeypatch.setenv("COLEARN_LOCK_WITNESS", value)
    assert not lockwitness.enabled()
    assert type(lockwitness.lock("x")) is _PLAIN_LOCK
    assert type(lockwitness.rlock("x")) is _PLAIN_RLOCK
    cv = lockwitness.condition("cv")
    assert type(cv) is threading.Condition
    assert type(cv._lock) is type(threading.Condition()._lock)
    for obj in ({"a": 1}, {1, 2}, [1, 2]):
        assert lockwitness.guarded(obj, "t", lockwitness.lock("x")) is obj
        assert lockwitness.guarded(obj, "t", cv) is obj


def test_off_mode_leaves_the_port_s_locks_plain(monkeypatch):
    """Unless the witness is on, the broker's lock and subscriptions and
    the aggregator's buffer condition are threading's own and a bare
    dict (the coordinators' are held to this by the planes test below,
    which builds them with the witness on)."""
    from colearn_federated_learning_tpu_torch.comm import aggregator, broker
    from test_torch_port_socket import configs

    monkeypatch.delenv("COLEARN_LOCK_WITNESS", raising=False)
    b = broker.MessageBroker()
    try:
        assert type(b._lock) is _PLAIN_LOCK
        assert type(b._subs) is dict
        agg = aggregator.AggregatorServer(configs()[1], 0, device="cpu")
        try:
            assert type(agg._abuf_cv) is threading.Condition
            assert not isinstance(agg._abuf_cv._lock,
                                  lockwitness.WitnessLock)
        finally:
            agg.stop()
    finally:
        b.stop()


def test_on_mode_names_the_port_s_locks_as_jax(witness_on):
    from colearn_federated_learning_tpu_torch.comm import aggregator, broker
    from test_torch_port_socket import configs

    b = broker.MessageBroker()
    try:
        assert isinstance(b._lock, lockwitness.WitnessLock)
        assert b._lock.name == "broker.lock"
        assert isinstance(b._subs, lockwitness._GuardedDict)
        assert b._subs._structure == "broker._subs"
        assert type(b._wlocks) is dict     # the port's own: not witnessed
        agg = aggregator.AggregatorServer(configs()[1], 3, device="cpu")
        try:
            assert agg._abuf_cv._lock.name == "agg3.abuf_cv"
        finally:
            agg.stop()
    finally:
        b.stop()


# ----------------------------------------------------------- inversion --
def test_seeded_inversion_is_witnessed(witness_on):
    a = lockwitness.lock("A")
    b = lockwitness.lock("B")
    with a:
        with b:
            pass                       # establishes A -> B
    with b:
        with a:                        # B -> A closes the ring
            pass
    rep = lockwitness.report()
    assert rep["edges"] == ["A->B", "B->A"]
    assert len(rep["inversions"]) == 1
    assert rep["inversions"][0]["edge"] == ["B", "A"]


def test_inversion_witnessed_even_when_acquire_times_out(witness_on):
    # The attempt alone records the inversion: a real deadlock never
    # reaches on_acquired.
    a = lockwitness.lock("A")
    b = lockwitness.lock("B")
    with a:
        with b:
            pass
    holder = threading.Event()
    release = threading.Event()

    def hold_a():
        with a:
            holder.set()
            release.wait(5.0)

    t = threading.Thread(target=hold_a)
    t.start()
    assert holder.wait(5.0)
    with b:
        got = a.acquire(timeout=0.05)
        assert not got
    release.set()
    t.join(5.0)
    rep = lockwitness.report()
    assert len(rep["inversions"]) == 1


def test_consistent_order_records_no_inversion(witness_on):
    a = lockwitness.lock("A")
    b = lockwitness.lock("B")
    for _ in range(3):
        with a:
            with b:
                pass
    rep = lockwitness.report()
    assert rep["edges"] == ["A->B"]
    assert rep["inversions"] == []
    assert rep["acquires"] == 6


# ------------------------------------------------------------- guarded --
def test_guarded_dict_stamps_unguarded_access(witness_on):
    lk = lockwitness.lock("G")
    d = lockwitness.guarded({}, "t._d", lk)
    with lk:
        d["a"] = 1                     # guarded: clean
    assert lockwitness.report()["unguarded"] == []
    d["b"] = 2                         # bare: witnessed
    for _ in d:
        pass
    rep = lockwitness.report()
    ops = [u["op"] for u in rep["unguarded"]]
    assert ops == ["setitem", "iter"]
    assert all(u["structure"] == "t._d" for u in rep["unguarded"])
    # the stamp names the caller's site, not the wrapper's
    assert "test_torch_port_lockwitness.py" in rep["unguarded"][0]["site"]


def test_guarded_set_and_list(witness_on):
    lk = lockwitness.lock("G")
    s = lockwitness.guarded(set(), "t._s", lk)
    xs = lockwitness.guarded([], "t._l", lk)
    with lk:
        s.add(1)
        xs.append(2)
    assert lockwitness.report()["unguarded"] == []
    s.add(3)
    xs.append(4)
    assert len(lockwitness.report()["unguarded"]) == 2


def test_condition_wait_keeps_held_stack_truthful(witness_on):
    cv = lockwitness.condition("CV")
    other = lockwitness.lock("L")
    fired = []

    def notifier():
        with cv:
            fired.append(True)
            cv.notify()

    with cv:
        t = threading.Timer(0.05, notifier)
        t.start()
        # wait() releases the witnessed lock through _release_save: a
        # stale held stack would give the notifier a bogus CV -> CV edge
        # or a deadlock; it must just succeed.
        assert cv.wait_for(lambda: fired, timeout=5.0)
        with other:                    # edge CV -> L, no inversion
            pass
    rep = lockwitness.report()
    assert rep["inversions"] == []
    assert "CV->L" in rep["edges"]


def test_condition_wait_releases_and_restores_the_witnessed_lock(witness_on):
    """On this interpreter ``threading.Condition`` takes the wrapper's
    ``_is_owned``, ``_release_save`` and ``_acquire_restore``: during a
    timed-out ``wait`` another thread takes the lock, and after it the
    waiter owns it again with one entry on its held stack."""
    cv = lockwitness.condition("CV")
    inner = cv._lock
    assert isinstance(inner, lockwitness.WitnessLock)
    assert cv._is_owned == inner._is_owned
    assert cv._release_save == inner._release_save
    assert cv._acquire_restore == inner._acquire_restore
    took = []

    def other():
        took.append(inner.acquire(timeout=5.0))
        inner.release()

    with cv:
        assert inner._is_owned()
        t = threading.Thread(target=other)
        t.start()
        assert not cv.wait(timeout=0.3)   # nobody notifies
        assert inner._is_owned()
        assert lockwitness._WITNESS.held() == ["CV"]
        t.join(5.0)
    assert took == [True]
    assert lockwitness._WITNESS.held() == []
    assert not inner._is_owned()
    with pytest.raises(RuntimeError):
        cv.wait(timeout=0.01)            # not held: threading's own error
    rep = lockwitness.report()
    assert rep["inversions"] == [] and rep["acquires"] == 3


def test_counts_survive_many_threads(witness_on):
    """More threads than cores, a short switch interval: every acquire
    and guarded op is counted once, the consistent order records no
    inversion, the guarded dict sees no bare access and no lost update."""
    import sys

    a, b = lockwitness.lock("A"), lockwitness.lock("B")
    d = lockwitness.guarded({"n": 0}, "t._d", b)
    n_threads, reps = 2 * (os.cpu_count() or 2) + 1, 200

    def work():
        for _ in range(reps):
            with a:
                with b:
                    d["n"] = d["n"] + 1

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60.0)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    rep = lockwitness.report()
    total = n_threads * reps
    assert rep["acquires"] == 2 * total
    assert rep["guarded_ops"] == 2 * total
    with b:
        assert d["n"] == total
    assert rep["edges"] == ["A->B"] and rep["inversions"] == []
    assert rep["unguarded"] == []


# ---------------------------------------------------------------- dump --
def test_atexit_dump_writes_per_pid_json(witness_on, monkeypatch, tmp_path):
    out = tmp_path / "lw"
    monkeypatch.setenv("COLEARN_LOCK_WITNESS_DIR", str(out))
    lockwitness.reset()
    a = lockwitness.lock("A")
    with a:
        pass
    lockwitness._WITNESS._dump()
    (path,) = sorted(out.glob("lockwitness-*.json"))
    assert path.name == f"lockwitness-{os.getpid()}.json"
    doc = json.loads(path.read_text())
    assert doc["acquires"] == 1 and doc["inversions"] == []


# ------------------------------------------------- procsoak collectors --
def _fake_report(**over):
    doc = {"enabled": True, "pid": 1, "acquires": 10, "guarded_ops": 5,
           "edges": [], "inversions": [], "unguarded": []}
    doc.update(over)
    return doc


def test_collect_lockwitness_aggregates_and_skips_garbage(tmp_path):
    d = tmp_path / "lockwitness"
    d.mkdir()
    (d / "lockwitness-1.json").write_text(json.dumps(_fake_report()))
    (d / "lockwitness-2.json").write_text(json.dumps(_fake_report(
        pid=2, inversions=[{"edge": ["B", "A"]}],
        unguarded=[{"structure": "x", "op": "iter"}])))
    (d / "lockwitness-3.json").write_text("{not json")
    (d / "flight-9.json").write_text("{}")      # a foreign file: ignored
    lw = procsoak._collect_lockwitness(str(d))
    assert lw["enabled"] and lw["reports"] == 2
    assert lw["reports_unparseable"] == 1
    assert lw["acquires"] == 20 and lw["guarded_ops"] == 10
    assert lw["inversions"] == 1 and lw["unguarded"] == 1
    assert lw["inversion_records"] == [{"edge": ["B", "A"]}]
    assert lw == jax_procsoak._collect_lockwitness(str(d))


def test_collect_lockwitness_missing_dir(tmp_path):
    lw = procsoak._collect_lockwitness(str(tmp_path / "nope"))
    assert lw["enabled"] and lw["reports"] == 0 and lw["inversions"] == 0
    assert lw == jax_procsoak._collect_lockwitness(str(tmp_path / "nope"))


MERGE_PARTS = [
    ({"enabled": False}, {"enabled": False}),
    ({"enabled": True, "reports": 4, "acquires": 100, "guarded_ops": 7,
      "inversions": 1, "unguarded": 0,
      "inversion_records": [{"edge": ["B", "A"]}], "unguarded_records": []},
     {"enabled": False},
     {"enabled": True, "reports": 4, "acquires": 50, "guarded_ops": 3,
      "inversions": 0, "unguarded": 2, "inversion_records": [],
      "unguarded_records": [{"op": "iter"}, {"op": "pop"}]})]


def test_merge_lockwitness():
    off = procsoak._merge_lockwitness(*MERGE_PARTS[0])
    assert off == {"enabled": False}
    merged = procsoak._merge_lockwitness(*MERGE_PARTS[1])
    assert merged["reports"] == 8 and merged["acquires"] == 150
    assert merged["inversions"] == 1 and merged["unguarded"] == 2
    assert len(merged["unguarded_records"]) == 2
    for parts in MERGE_PARTS:
        assert procsoak._merge_lockwitness(*parts) == \
            jax_procsoak._merge_lockwitness(*parts)


# ------------------------------------------- the same scenarios as JAX --
def _scenario(lw, name: str) -> dict:
    """One seeded scenario through witness module ``lw`` (either
    package's), from a fresh state; returns its report."""
    lw.reset()
    a, b = lw.lock("A"), lw.lock("B")
    if name == "inversion":
        with a:
            with b:
                pass
        with b:
            with a:
                pass
    elif name == "timeout":
        with a:
            with b:
                pass
        holder, release = threading.Event(), threading.Event()

        def hold_a():
            with a:
                holder.set()
                release.wait(5.0)

        t = threading.Thread(target=hold_a, name="holder")
        t.start()
        assert holder.wait(5.0)
        with b:
            assert not a.acquire(timeout=0.05)
        release.set()
        t.join(5.0)
    elif name in ("dict", "set", "list"):
        obj = {"dict": {}, "set": set(), "list": []}[name]
        g = lw.guarded(obj, f"t._{name}", a)
        with a:
            if name == "dict":
                g["a"] = 1
                g.get("a")
            elif name == "set":
                g.add(1)
                g.discard(2)
            else:
                g.append(1)
                g.extend([2])
        with b:                        # the wrong lock is no guard
            for _ in g:
                pass
        if name == "dict":
            g["b"] = 2
            g.pop("a")
            list(g.items())
        elif name == "set":
            g.add(3)
            g.remove(1)
        else:
            g.append(3)
            g.pop()
            g[0] = 5
    elif name == "condition":
        cv = lw.condition("CV")
        fired = []

        def notifier():
            with cv:
                fired.append(True)
                cv.notify_all()

        with cv:
            t = threading.Timer(0.05, notifier)
            t.start()
            assert cv.wait_for(lambda: fired, timeout=5.0)
            with a:
                with b:
                    pass
            t.join(5.0)
        with b:
            with cv:                   # B -> CV closes CV -> A -> B
                pass
    return lw.report()


@pytest.mark.parametrize("name", ["inversion", "timeout", "dict", "set",
                                  "list", "condition"])
def test_reports_equal_jax_s_on_the_same_scenarios(witness_on, name):
    ours = _scenario(lockwitness, name)
    theirs = _scenario(jax_lw, name)
    assert ours.pop("pid") == theirs.pop("pid") == os.getpid()
    assert ours == theirs
    assert sorted(ours) == ["acquires", "edges", "enabled", "guarded_ops",
                            "inversions", "unguarded"]
    if name in ("inversion", "timeout", "condition"):
        assert len(ours["inversions"]) == 1
    if name in ("dict", "set", "list"):
        assert len(ours["unguarded"]) >= 3 and ours["guarded_ops"] >= 5
        assert {u["site"].split(":")[0] for u in ours["unguarded"]} == \
            {"test_torch_port_lockwitness.py"}


def test_collectors_equal_jax_s_over_both_packages_dumps(witness_on,
                                                        monkeypatch,
                                                        tmp_path):
    out = tmp_path / "lockwitness"
    monkeypatch.setenv("COLEARN_LOCK_WITNESS_DIR", str(out))
    own = out / f"lockwitness-{os.getpid()}.json"
    _scenario(jax_lw, "inversion")
    jax_lw._WITNESS._dump()
    own.rename(out / "lockwitness-1.json")       # one pid, two writers
    _scenario(lockwitness, "dict")
    lockwitness._WITNESS._dump()
    assert sorted(p.name for p in out.iterdir()) == sorted(
        ["lockwitness-1.json", own.name])
    ours = procsoak._collect_lockwitness(str(out))
    assert ours == jax_procsoak._collect_lockwitness(str(out))
    assert ours["reports"] == 2 and ours["inversions"] == 1
    assert ours["unguarded"] >= 3
    off = {"enabled": False}
    assert procsoak._merge_lockwitness(ours, off, ours) == \
        jax_procsoak._merge_lockwitness(ours, off, ours)


# ------------------------------------------ the port's planes, witnessed --
@pytest.fixture
def planes_witnessed(monkeypatch):
    monkeypatch.setenv("COLEARN_LOCK_WITNESS", "1")
    monkeypatch.delenv("COLEARN_LOCK_WITNESS_DIR", raising=False)
    lockwitness.reset()
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
    lockwitness.reset()


def _flat_async():
    from test_torch_port_async import federation
    from test_torch_port_socket import configs

    with federation(configs(num_clients=4), 4, buffer_size=2) as (c, _, _):
        records = c.fit(aggregations=3)
        names = (c._state_lock.name, c._version_cv._lock.name,
                 c._health_lock.name, c._inflight_lock.name,
                 c._agg_lock.name, c._agg_refreshing.name)
    assert [r["model_version"] for r in records] == [1, 2, 3]
    assert names == ("coord.state_lock", "coord.version_cv",
                     "coord.health_lock", "coord.inflight_lock",
                     "coord.agg_lock", "coord.agg_refreshing")


def _tree_async_with_a_stop():
    from test_torch_port_tree_async import tree, tree_configs

    with tree(tree_configs(), buffer_size=2) as (c, tier):
        records = [c.run_aggregation() for _ in range(2)]
        tier[0].stop()
        records += [c.run_aggregation() for _ in range(3)]
        assert isinstance(c._inflight, lockwitness._GuardedDict)
        assert isinstance(c._aggs, lockwitness._GuardedDict)
        c.close()
    assert [r["model_version"] for r in records] == list(range(1, 6))
    keys = [k for r in records for k in r["folded_keys"]]
    assert len(keys) == len(set(keys))


def _sync_tree_round():
    from test_torch_port_tree import tree_configs, tree_run

    hist, _ = tree_run(tree_configs(), 3, rounds=1)
    assert hist[0]["completed"] == 3 and hist[0]["aggregators"] == 2


PLANES = {"flat_async_k2": _flat_async,
          "tree_async_aggregator_stopped": _tree_async_with_a_stop,
          "sync_tree_round": _sync_tree_round}


@pytest.mark.parametrize("plane", sorted(PLANES))
def test_port_planes_run_clean_under_the_witness(planes_witnessed, plane):
    t0 = time.monotonic()
    PLANES[plane]()
    rep = lockwitness.report()
    assert rep["enabled"] and rep["acquires"] >= 1
    assert rep["guarded_ops"] >= 1
    assert rep["inversions"] == [], rep["inversions"]
    assert rep["unguarded"] == [], rep["unguarded"]
    assert time.monotonic() - t0 < 60.0
