"""The port's closure powering on the device (keto_tpu_torch.engine.
closure_power and closure.powering = "device") held against the JAX
package's on identical inputs, on the CPU, where the dispatchers run P1-P3's
plain versions.

- builds: power_closure_device(device="cpu") gives the seven ClosureBuild
  arrays of keto_tpu's power_closure_device, keto_tpu's host power_closure
  and the port's host power_closure, byte for byte, with equal n_nodes,
  vocab_fp and n_entries and keto_tpu's wave record, over the
  tests/test_closure_power.py TestBitIdentity cases: deep chains, depth
  caps 1, 2 and 5, row caps 1 and 3, cycles, island poison, relation-not-
  found poison, a source subset, a forced multi-wave build; depth 101
  raises PoweringUnsupported
- waves: closure_power_wave's level plane and summary (launch stats
  included) equal keto_tpu's jitted closure_power_wave on the same random
  subgraphs, at 32, 64 and 128 lanes, with and without a row-cap kill,
  with poisoned nodes
- engines: TorchCheckEngine(device="cpu") with closure.powering = "device"
  builds through the device path, equal to the host-powered build, answers
  like TPUCheckEngine and the oracle, powers a write's dirty sources
  again on the device (a refresh) and a compacted base in full, each
  index equal to keto_tpu's; "host" is the default; depth 101 powers on the host,
  counted; a failing wave raises and nothing powers on the host
- the 32-bit index limit (cuda_ops.INDEX_LIMIT, patched low): a planned
  wave that reaches it raises PoweringUnsupported naming N·W, E·W or
  D·32W before any P1-P3 call, and the engine answers from the host
  builder's arrays with one counted fallback; a limit one word past the
  widest wave leaves the build, its record and its calls as they were

Tolerance: exact equality; every output is an integer.
"""

import numpy as np
import pytest
import torch

import keto_tpu.engine.closure as jcl
import keto_tpu.engine.closure_power as jcp
import keto_tpu.engine.snapshot as jsnap
from keto_tpu.ketoapi import RelationTuple as JTuple
from keto_tpu.namespace import Namespace as JNamespace
from keto_tpu.namespace.ast import (
    ComputedSubjectSet,
    InvertResult,
    Operator,
    Relation,
    SubjectSetRewrite,
)

from keto_tpu_torch.config import Config as TConfig
from keto_tpu_torch.engine import closure as tcl
from keto_tpu_torch.engine import closure_power as tcp
from keto_tpu_torch.engine import snapshot as tsnap
from keto_tpu_torch.engine.torch_engine import TorchCheckEngine
from keto_tpu_torch.ketoapi import RelationTuple as TTuple
from keto_tpu_torch.storage import MemoryManager as TMemory

from test_torch_closure import (
    BUILD_FIELDS,
    DEPTH,
    OTHER_QUERIES,
    Pair,
    compacting_writes,
    deep_queries,
    namespaces,
    same_index,
    tuples_and_owners,
)
from test_torch_kernel import layout, port_namespaces  # noqa: F401  (layout is a fixture)

RECORD_FIELDS = ("waves", "steps", "lanes", "nodes", "edges", "hbm")


# -- the stores: test_torch_closure's combined store and keto_tpu's small shapes ------


def cycles():
    ns = [JNamespace(name="g", relations=[Relation(name="member")])]
    return ns, ["g:x#member@(g:y#member)", "g:y#member@(g:x#member)", "g:x#member@alice"], 8


def island():
    ns = [JNamespace(name="acl", relations=[
        Relation(name="allow"), Relation(name="deny"),
        Relation(name="access", subject_set_rewrite=SubjectSetRewrite(
            operation=Operator.AND,
            children=[ComputedSubjectSet(relation="allow"),
                      InvertResult(child=ComputedSubjectSet(relation="deny"))])),
        Relation(name="group"),
    ])]
    return ns, ["acl:d#allow@u1", "acl:g#group@(acl:d#access)", "acl:h#group@u2"], 6


def relation_not_found():
    ns = [JNamespace(name="cfg", relations=[Relation(name="member")])]
    return ns, ["cfg:a#member@(cfg:b#ghost)", "cfg:b#ghost@u1"], 6


def combined():
    tuples, _owners = tuples_and_owners()
    return namespaces(), tuples, DEPTH + 4


STORES = {"combined": combined, "cycles": cycles, "island": island,
          "relation_not_found": relation_not_found}


def operands(store):
    """(jax snapshot, jax graph, port snapshot, port graph, max depth) of a
    store; the port's layout is the JAX package's, so vocab_fp compares."""
    ns, tuples, depth = STORES[store]()
    jsn = jsnap.build_snapshot([JTuple.from_string(s) for s in tuples], ns)
    tsn = tsnap.build_snapshot([TTuple.from_string(s) for s in tuples], port_namespaces(ns),
                               layout=jsnap.table_layout())
    return jsn, jcl.extract_graph(jsn), tsn, tcl.extract_graph(tsn), depth


def assert_builds_equal(got, want):
    for k in BUILD_FIELDS:
        a, b = getattr(got, k), getattr(want, k)
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(a, b, err_msg=k)
    assert (got.n_nodes, got.vocab_fp, got.n_entries) == (want.n_nodes, want.vocab_fp,
                                                          want.n_entries)


# -- (a) builds -----------------------------------------------------------------------

CASES = {
    # name: (store, max_depth or None for the store's, max_set_rows, sources step, budget)
    "deep_chains": ("combined", None, 64, None, None),
    "depth_1": ("combined", 1, 64, None, None),
    "depth_2": ("combined", 2, 64, None, None),
    "depth_5": ("combined", 5, 64, None, None),
    "rows_1": ("combined", None, 1, None, None),
    "rows_3": ("combined", None, 3, None, None),
    "cycles_min_depth": ("cycles", None, 64, None, None),
    "island_poison": ("island", None, 64, None, None),
    "relation_not_found_poison": ("relation_not_found", None, 64, None, None),
    "subset_sources": ("combined", None, 64, 3, None),
    "forced_multi_wave": ("combined", None, 64, None, 0),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_device_build_identical(case, monkeypatch):
    store, depth, msr, step, budget = CASES[case]
    jsn, jg, tsn, tg, store_depth = operands(store)
    depth = store_depth if depth is None else depth
    jsrc = jg.universe[::step] if step else None
    tsrc = tg.universe[::step] if step else None
    kw = {} if budget is None else {"budget_bytes": budget}
    if budget is not None:
        monkeypatch.setenv("KETO_CLOSURE_POWER_MB", str(budget >> 20))
    got, record = tcp.power_closure_device(tg, tsn, depth, msr, 7, sources=tsrc, device="cpu",
                                           **kw)
    want, jrecord = jcp.power_closure_device(jg, jsn, depth, msr, 7, sources=jsrc)
    assert_builds_equal(got, want)
    assert_builds_equal(got, jcl.power_closure(jg, jsn, depth, msr, 7, sources=jsrc))
    assert_builds_equal(got, tcl.power_closure(tg, tsn, depth, msr, 7, sources=tsrc))
    assert {k: record[k] for k in RECORD_FIELDS} == {k: jrecord[k] for k in RECORD_FIELDS}
    assert record["steps"] > 0 and record["prep_s"] >= 0 and record["wave_s"] > 0
    assert (got.snapshot_version, got.base_version, got.max_depth, got.max_set_rows) == (
        tsn.version, 7, depth, msr)
    # the port's own buffers: the same operands, packed words in place of
    # keto_tpu's unpacked [E, S] / [N, S] planes
    assert record["device_hbm"]["adjacency_pack"] == record["hbm"]["adjacency_pack"]
    assert 0 < record["device_hbm"]["scratch"] < record["hbm"]["scratch"]
    if case == "forced_multi_wave":
        assert record["waves"] > 1
    if store == "combined" and step is None and budget is None:
        assert record["lanes"] >= 64  # several words a row, bit 31 of word 0 in use
    if msr < 4:
        assert len(got.covered_keys) < len(tg.universe)


def test_depth_past_int8_plane_raises():
    _jsn, _jg, tsn, tg, _depth = operands("combined")
    with pytest.raises(tcp.PoweringUnsupported, match="int8"):
        tcp.power_closure_device(tg, tsn, 101, 64, 0, device="cpu")


@pytest.mark.parametrize("lanes", [32, 4096])
def test_device_power_bytes_count_packed_words_only(lanes):
    N, E, D = 8192, 2048, 4096
    want = jcp.estimate_power_bytes(N, E, D, lanes)
    assert tcp.estimate_power_bytes(N, E, D, lanes) == want
    got = tcp.device_power_bytes(N, E, D, lanes)
    assert got == {"adjacency_pack": want["adjacency_pack"],
                   "bit_matrix": 3 * N * lanes // 8 + 2 * D * lanes,
                   "scratch": 2 * N * lanes // 8}
    assert sum(got.values()) < sum(want.values())


def test_empty_sources_build():
    _jsn, _jg, tsn, tg, depth = operands("cycles")
    got, record = tcp.power_closure_device(tg, tsn, depth, 64, 0,
                                           sources=np.zeros(0, np.int64), device="cpu")
    assert got.n_nodes == 0 and got.n_entries == 0 and record["waves"] == 0


# -- (b) one wave -------------------------------------------------------------------------


def wave_inputs(lanes, seed, n_sub=40, n_edges=70):
    """One wave's inputs as keto_tpu's run_range lays them out: a random
    subgraph of n_sub nodes with a dummy node at n_sub, dst-sorted edges
    and direct rows padded with the dummy, random poisoned nodes, and
    lanes - 3 sources (so the last word holds padding lanes) with their
    self bits, levels and counts."""
    rng = np.random.default_rng(seed)
    Nq = tcp._next_pow2(n_sub + 1, 2)
    Eq = tcp._next_pow2(n_edges, 1)
    src, dst = rng.integers(0, n_sub, n_edges), rng.integers(0, n_sub, n_edges)
    order = np.argsort(dst, kind="stable")
    e_src = np.full(Eq, n_sub, np.int32)
    e_dst = np.full(Eq, n_sub, np.int32)
    e_src[:n_edges], e_dst[:n_edges] = src[order], dst[order]
    dnodes = np.sort(rng.choice(n_sub, n_sub // 2, replace=False)).astype(np.int32)
    Dq = tcp._next_pow2(len(dnodes), 1)
    d_rows = np.full(Dq, n_sub, np.int32)
    d_rows[:len(dnodes)] = dnodes
    pois = np.zeros(Nq, np.uint8)
    pois[rng.choice(n_sub, 2, replace=False)] = 1
    nl = lanes - 3
    snode = rng.integers(0, n_sub, nl)
    lane_ids = np.arange(nl)
    R0 = np.zeros((Nq, lanes // 32), np.uint32)
    np.bitwise_or.at(R0, (snode, lane_ids // 32), np.uint32(1) << (lane_ids % 32).astype(np.uint32))
    lvl0 = np.full((Dq, lanes), -1, np.int8)
    pos = np.searchsorted(dnodes, snode).clip(0, len(dnodes) - 1)
    at_d = dnodes[pos] == snode
    lvl0[pos[at_d], lane_ids[at_d]] = 0
    counts0 = np.zeros(lanes, np.int32)
    counts0[:nl] = 1
    return e_src, e_dst, d_rows, pois, R0, lvl0, counts0


@pytest.mark.parametrize("max_set_rows", [1 << 20, 3, 0])
@pytest.mark.parametrize("lanes", [32, 64, 128, 2048, 8192])
def test_wave_identical(lanes, max_set_rows):
    """One wave against keto_tpu's at 1, 2, 4, 64 and 256 words a row
    (2,048 lanes: the widest deep-1e6 wave's; 8,192: the widest wave the
    kernels take), with no row cap, a cap of 3 and a cap of 0 (every
    source is killed after its first step)."""
    import jax.numpy as jnp

    inputs = wave_inputs(lanes, seed=lanes + max_set_rows)
    want_lvl, want_summary = (np.asarray(x) for x in jcp.closure_power_wave(
        *(jnp.asarray(a) for a in inputs), max_depth=9, max_set_rows=max_set_rows))
    e_src, e_dst, d_rows, pois, R0, lvl0, counts0 = inputs
    lvl, summary = tcp.closure_power_wave(
        *(torch.from_numpy(a) for a in (e_src, e_dst, d_rows, pois, R0.view(np.int32), lvl0,
                                        counts0)),
        max_depth=9, max_set_rows=max_set_rows)
    assert lvl.dtype == torch.int8 and summary.dtype == torch.int32
    np.testing.assert_array_equal(lvl.numpy(), want_lvl)
    np.testing.assert_array_equal(summary.numpy(), want_summary)
    counts, pois_out = summary[:lanes].numpy(), summary[lanes:2 * lanes].numpy()
    stats = summary[2 * lanes:].numpy()
    # the cases reached what they are for: several steps (one under a cap
    # of 0), poison, a kill
    assert stats[0] == 1 if max_set_rows == 0 else stats[0] >= 2
    assert pois_out.any() and (lvl.numpy() > 0).any()
    assert (counts > max_set_rows).any() == (max_set_rows < 1 << 20)
    # inputs are not updated in place
    np.testing.assert_array_equal(R0.view(np.int32), inputs[4].view(np.int32))


@pytest.mark.parametrize("name", ["power_step", "power_account", "power_poison"])
def test_wrappers_take_cuda_tensors_only(name):
    """On a CPU tensor a wrapper raises before building or launching
    anything, and counts nothing: CPU tensors go to the plain versions."""
    from keto_tpu_torch.engine import cuda_ops

    e_src, e_dst, d_rows, pois, R0, lvl0, counts0 = (
        torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)
        for a in wave_inputs(64, seed=1))
    stats = torch.zeros(8, dtype=torch.int32)
    status = torch.ones(1, dtype=torch.int32)
    call = {
        "power_step": lambda: cuda_ops.power_step(R0, R0.clone(), e_src, e_dst, counts0, stats,
                                                  status),
        "power_account": lambda: cuda_ops.power_account(R0, lvl0, counts0, d_rows, status,
                                                        level=1, max_set_rows=4),
        "power_poison": lambda: cuda_ops.power_poison(R0, pois, counts0, stats),
    }[name]
    before = cuda_ops.launches[name]
    with pytest.raises(ValueError, match="CUDA tensors"):
        call()
    assert cuda_ops.launches[name] == before


def test_bit_planes_round_trip():
    words = torch.tensor([[0, -1, -2**31, 2**31 - 1, 5]], dtype=torch.int32)
    planes = tcp._unpack(words)
    assert planes.shape == (1, 160) and planes[0, 63] == 1 and planes[0, 95] == 1
    assert torch.equal(tcp._pack(planes), words)
    assert tcp._popcount(words).tolist() == [[0, 32, 1, 31, 2]]


# -- (c) the engines ------------------------------------------------------------------------


def port_engine(ns, tuples):
    """The port's engine alone, closure on, with the default powering."""
    cfg = TConfig({"limit": {"max_read_depth": DEPTH + 4}, "closure": {"enabled": True}})
    cfg.set_namespaces(port_namespaces(ns))
    m = TMemory()
    m.write_relation_tuples([TTuple.from_string(s) for s in tuples])
    return TorchCheckEngine(m, cfg, device="cpu")


@pytest.fixture(scope="module")
def store():
    tuples, owners = tuples_and_owners()
    return namespaces(), tuples, owners


def test_engine_device_powering_equals_host_and_jax(store):
    ns, tuples, owners = store
    p = Pair(ns, tuples, powering="device")
    assert p.port.closure_ensure_built() and p.jax.closure_ensure_built()
    idx = p.port.closure_index()
    assert idx.powering == "device"
    assert idx.stats["device_builds"] == 1 and idx.stats["device_fallbacks"] == 0
    assert idx.stats["power_waves"] > 0 and idx.stats["power_steps"] > 0
    desc = idx.describe()
    assert set(desc["power_hbm"]) == {"adjacency_pack", "bit_matrix", "scratch"}
    assert desc["power_hbm"]["scratch"] > 0
    assert desc["power_prep_s"] >= 0 and desc["power_wave_s"] > 0
    assert desc["power_s"] >= desc["power_prep_s"] + desc["power_wave_s"]
    host = port_engine(ns, tuples)
    assert host.closure_ensure_built()
    assert_builds_equal(idx._build, host.closure_index()._build)
    for depth in (0, 3):
        p.check(deep_queries(owners) + OTHER_QUERIES, depth)
    p.same_closure_stats()
    assert p.port.stats["closure_hits"] > 0


def test_engine_refresh_and_rebuild_after_write_stay_on_device(store, layout):
    """After a write the written chain's nodes are dirty: their checks fall
    back (dirty), the rest hit, all correct. closure_ensure_built() powers
    the dirty sources again on the device (a device build over a source
    subset, no host fallback), as keto_tpu's index does; the hits resume,
    the written grant included. A write that compacts the mirror gives a
    new base, which the index powers on the device again."""
    ns, tuples, owners = store
    p = Pair(ns, tuples, powering="device", layout=layout)
    assert p.port.closure_ensure_built() and p.jax.closure_ensure_built()
    idx = p.port.closure_index()
    queries = deep_queries(owners, n=16) + ["deep:c2f0#viewer@newbie"]
    p.write([f"deep:c2f{DEPTH}#owner@newbie"])
    got = p.check(queries)
    fallback = p.port.stats["closure_fallback"]
    assert fallback == {"dirty": sum(q.startswith("deep:c2f") for q in queries)}
    assert got[-1].allowed
    assert p.port.closure_ensure_built() and p.jax.closure_ensure_built()
    assert idx.stats["device_builds"] == 2 and idx.stats["device_fallbacks"] == 0
    assert idx.stats["builds"] == 1 and idx.stats["refreshes"] == 1
    assert idx.last_refresh["power_waves"] == 1 and idx.last_refresh["sources"] == DEPTH + 2
    same_index(idx, p.jax.closure_index())
    hits = p.port.stats["closure_hits"]
    p.check(queries)
    assert p.port.stats["closure_hits"] == hits + len(queries)
    p.write(compacting_writes())
    assert p.port.closure_ensure_built() and p.jax.closure_ensure_built()
    assert idx.stats["device_builds"] == 3 and idx.stats["device_fallbacks"] == 0
    same_index(idx, p.jax.closure_index())
    hits = p.port.stats["closure_hits"]
    p.check(queries)
    assert p.port.stats["closure_hits"] == hits + len(queries)
    assert p.port.stats["incremental_merges"] == p.jax.stats.get("incremental_merges", 0) == 1


def test_default_powering_is_host(store):
    ns, tuples, _owners = store
    engine = port_engine(ns, tuples)
    assert engine.closure_ensure_built()
    idx = engine.closure_index()
    assert idx.powering == "host" and idx.describe()["powering"] == "host"
    assert idx.stats["device_builds"] == 0 and idx.stats["device_fallbacks"] == 0
    assert "power_prep_s" not in idx.last_build
    with pytest.raises(ValueError, match="closure.powering"):
        tcl.ClosureIndex("n", "cpu", powering="gpu")


def test_depth_past_int8_plane_powers_on_host_counted(store):
    ns, tuples, owners = store
    p = Pair(ns, tuples, max_depth=101, powering="device")
    assert p.port.closure_ensure_built()
    idx = p.port.closure_index()
    assert idx.stats["device_fallbacks"] == 1 and idx.stats["device_builds"] == 0
    assert "int8" in idx.last_build["power_fallback"]
    p.check(deep_queries(owners, n=16) + OTHER_QUERIES)
    assert p.port.stats["closure_hits"] > 0


def test_failing_wave_raises_without_host_build(store, monkeypatch):
    ns, tuples, _owners = store

    def boom(*args, **kwargs):
        raise RuntimeError("injected wave failure")

    def no_host(*args, **kwargs):
        raise AssertionError("the host builder ran")

    monkeypatch.setattr(tcp, "closure_power_wave", boom)
    monkeypatch.setattr(tcl, "power_closure", no_host)
    p = Pair(ns, tuples, powering="device")
    with pytest.raises(RuntimeError, match="injected wave failure"):
        p.port.closure_ensure_built()
    idx = p.port.closure_index()
    assert idx.stats == dict.fromkeys(idx.stats, 0)
    assert set(idx.stats) >= {"builds", "device_builds", "device_fallbacks", "power_waves",
                              "power_steps"}
    assert idx.needs_rebuild()


# -- (d) the 32-bit index limit of P1-P3 (cuda_ops.INDEX_LIMIT) ------------------------
#
# The wave plan runs before any launch, so a wave past a wrapper's 32-bit
# limit powers the build on the host, counted, with no P1-P3 call. The
# limit is patched low enough for the test store's waves to reach it.


@pytest.fixture
def counted(monkeypatch):
    """Counts the calls of P1-P3's dispatchers, which still run."""
    calls = {"power_step": 0, "power_account": 0, "power_poison": 0}
    for name in calls:
        real = getattr(tcp, name)

        def wrapped(*args, _name=name, _real=real, **kw):
            calls[_name] += 1
            return _real(*args, **kw)

        monkeypatch.setattr(tcp, name, wrapped)
    return calls


@pytest.fixture
def planned(monkeypatch):
    """The (N·W, E·W, D·32W) of every wave the plan checks."""
    sizes = []
    real = tcp._require_index_limit

    def spy(s, e, Nq, Eq, Dq, lanes):
        sizes.append((Nq * lanes // 32, Eq * lanes // 32, Dq * lanes))
        return real(s, e, Nq, Eq, Dq, lanes)

    monkeypatch.setattr(tcp, "_require_index_limit", spy)
    return sizes


@pytest.mark.parametrize("what,Nq,Eq,Dq", [
    ("N·W", 1024, 16, 16), ("E·W", 16, 1024, 16), ("D·32W", 16, 16, 32)])
def test_index_limit_names_the_size_that_reaches_it(what, Nq, Eq, Dq, monkeypatch):
    """At 32 lanes (W = 1) each of N·W, E·W and D·32W trips the limit alone."""
    from keto_tpu_torch.engine import cuda_ops

    monkeypatch.setattr(cuda_ops, "INDEX_LIMIT", 1024)
    with pytest.raises(tcp.PoweringUnsupported, match=f"{what} = 1024 words.*limit 1024"):
        tcp._require_index_limit(0, 32, Nq, Eq, Dq, 32)
    tcp._require_index_limit(0, 32, Nq - 1 if what == "N·W" else Nq,
                             Eq - 1 if what == "E·W" else Eq, Dq // 2 if what == "D·32W" else Dq,
                             32)


def test_wave_past_index_limit_raises_before_any_launch(counted, monkeypatch):
    from keto_tpu_torch.engine import cuda_ops

    _jsn, _jg, tsn, tg, depth = operands("combined")
    monkeypatch.setattr(cuda_ops, "INDEX_LIMIT", 64)
    with pytest.raises(tcp.PoweringUnsupported, match="32-bit index limit 64"):
        tcp.power_closure_device(tg, tsn, depth, 64, 0, device="cpu")
    assert counted == {"power_step": 0, "power_account": 0, "power_poison": 0}


def test_engine_past_index_limit_powers_on_host_counted(store, counted, monkeypatch):
    """closure_ensure_built answers: the host builder's arrays, one counted
    fallback naming the limit, no P1-P3 call."""
    from keto_tpu_torch.engine import cuda_ops

    ns, tuples, owners = store
    monkeypatch.setattr(cuda_ops, "INDEX_LIMIT", 64)
    p = Pair(ns, tuples, powering="device")
    assert p.port.closure_ensure_built() and p.jax.closure_ensure_built()
    idx = p.port.closure_index()
    assert idx.stats["device_fallbacks"] == 1 and idx.stats["device_builds"] == 0
    assert "32-bit index limit 64" in idx.last_build["power_fallback"]
    assert counted == {"power_step": 0, "power_account": 0, "power_poison": 0}
    host = port_engine(ns, tuples)
    assert host.closure_ensure_built()
    assert_builds_equal(idx._build, host.closure_index()._build)
    p.check(deep_queries(owners, n=16) + OTHER_QUERIES)
    p.same_closure_stats()
    assert p.port.stats["closure_hits"] > 0


def test_untripped_index_limit_leaves_device_build_as_it_was(counted, planned, monkeypatch):
    """A limit one word past the widest wave's largest size gives the same
    build, wave record and P1-P3 calls as the default limit."""
    from keto_tpu_torch.engine import cuda_ops

    _jsn, _jg, tsn, tg, depth = operands("combined")
    want, want_record = tcp.power_closure_device(tg, tsn, depth, 64, 0, device="cpu")
    want_calls, widest = dict(counted), max(max(s) for s in planned)
    assert want_calls["power_step"] > 0 and want_calls["power_poison"] == want_record["waves"]
    for k in counted:
        counted[k] = 0
    monkeypatch.setattr(cuda_ops, "INDEX_LIMIT", widest + 1)
    got, record = tcp.power_closure_device(tg, tsn, depth, 64, 0, device="cpu")
    assert_builds_equal(got, want)
    assert {k: record[k] for k in RECORD_FIELDS} == {k: want_record[k] for k in RECORD_FIELDS}
    assert counted == want_calls
    monkeypatch.setattr(cuda_ops, "INDEX_LIMIT", widest)
    with pytest.raises(tcp.PoweringUnsupported, match="32-bit index limit"):
        tcp.power_closure_device(tg, tsn, depth, 64, 0, device="cpu")
