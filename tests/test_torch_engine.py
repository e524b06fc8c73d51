"""TorchCheckEngine on the CPU against the JAX package's TPUCheckEngine
and the exact host oracle, on the same store contents: verdicts, errors,
device/host counts and host-replay causes. Also the port's import
boundary (no jax, nothing of keto_tpu) and its refusal to run a CUDA
engine where there is no card.
"""

import os
import random
import subprocess
import sys

import pytest
import torch

from keto_tpu.config import Config as JConfig
from keto_tpu.engine.tpu_engine import TPUCheckEngine
from keto_tpu.ketoapi import RelationTuple as JTuple
from keto_tpu.storage import MemoryManager as JMemory

from keto_tpu_torch.config import Config as TConfig
from keto_tpu_torch.engine import Membership, ReferenceEngine as TReference
from keto_tpu_torch.engine.torch_engine import TorchCheckEngine
from keto_tpu_torch.ketoapi import RelationTuple as TTuple
from keto_tpu_torch.storage import MemoryManager as TMemory

from test_torch_kernel import SCENARIOS, port_namespaces

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class Pair:
    """The same store and config behind both engines and both oracles."""

    def __init__(self, namespaces, tuples, max_depth, layout="bucketized", **kw):
        self.jcfg = JConfig({"limit": {"max_read_depth": max_depth}})
        self.jcfg.set_namespaces(namespaces)
        self.tcfg = TConfig({"limit": {"max_read_depth": max_depth}})
        self.tcfg.set_namespaces(port_namespaces(namespaces))
        self.jm, self.tm = JMemory(), TMemory()
        self.write(tuples)
        self.jax = TPUCheckEngine(self.jm, self.jcfg, **kw)
        self.port = TorchCheckEngine(self.tm, self.tcfg, device="cpu", layout=layout, **kw)

    def write(self, tuples):
        self.jm.write_relation_tuples([JTuple.from_string(s) for s in tuples])
        self.tm.write_relation_tuples([TTuple.from_string(s) for s in tuples])

    def delete(self, tuples):
        self.jm.delete_relation_tuples([JTuple.from_string(s) for s in tuples])
        self.tm.delete_relation_tuples([TTuple.from_string(s) for s in tuples])

    def compare(self, queries, max_depth=0, pruning=True):
        got = self.port.check_batch([TTuple.from_string(q) for q in queries], max_depth)
        want = self.jax.check_batch([JTuple.from_string(q) for q in queries], max_depth)
        oracle = TReference(self.tm, self.tcfg, visited_pruning=pruning)
        for q, g, w in zip(queries, got, want):
            ref = oracle.check_relation_tuple(TTuple.from_string(q), max_depth)
            assert (g.error is None) == (w.error is None) == (ref.error is None), q
            if g.error is not None:
                assert type(g.error).__name__ == type(w.error).__name__, q
                continue
            assert g.membership == w.membership == ref.membership, q
        return got


def _assert_same_routing(pair):
    for key in ("device_checks", "host_checks", "host_cause"):
        assert pair.port.stats[key] == pair.jax.stats[key], key


@pytest.mark.parametrize("layout", ["bucketized", "compact"])
@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_engine_matches_jax_engine_and_oracle(scenario, layout):
    namespaces, tuples, queries, max_depth = SCENARIOS[scenario]()
    pair = Pair(namespaces, tuples, max_depth, layout=layout)
    # cyclic random graphs: the pruning-free walk is the device semantics
    pair.compare(queries, max_depth, pruning=not scenario.startswith("random"))
    _assert_same_routing(pair)


def test_rewrite_fixtures_run_on_device():
    namespaces, tuples, queries, max_depth = SCENARIOS["rewrite_fixtures"]()
    pair = Pair(namespaces, tuples, max_depth)
    pair.compare(queries, max_depth)
    # only the unknown-object query needs the host
    assert pair.port.stats["host_checks"] == 1
    assert pair.port.stats["host_cause"] == {"unindexed": 1}


def test_writes_then_recheck():
    namespaces, tuples, queries, max_depth = SCENARIOS["cat_videos"]()
    pair = Pair(namespaces, tuples, max_depth)
    pair.compare(queries)
    pair.write(["videos:/cats/2.mp4#view@john", "videos:/dogs#owner@john"])
    pair.delete(["videos:/cats#owner@cat lady"])
    pair.compare(queries + ["videos:/dogs#owner@john", "videos:/dogs#view@john"])
    # the writes fold into the overlay: one build, as in the JAX engine
    assert pair.port.stats["snapshot_builds"] == pair.jax.stats["snapshot_builds"] == 1
    assert pair.port._state.has_delta
    pair.compare(queries)
    # store unchanged: no rebuild, no compaction
    assert pair.port.stats["snapshot_builds"] == pair.jax.stats["snapshot_builds"] == 1
    assert pair.port.stats["incremental_merges"] == \
        pair.jax.stats.get("incremental_merges", 0) == 0
    _assert_same_routing(pair)


def test_namespace_config_change_rebuilds():
    from keto_tpu.namespace import Namespace
    from keto_tpu.namespace.ast import ComputedSubjectSet, Relation, SubjectSetRewrite

    plain = [Namespace(name="n", relations=[Relation(name="owner"), Relation(name="editor")])]
    pair = Pair(plain, ["n:o#owner@u"], 5)
    assert pair.compare(["n:o#editor@u"])[0].membership == Membership.NOT_MEMBER
    rewritten = [Namespace(name="n", relations=[
        Relation(name="owner"),
        Relation(name="editor", subject_set_rewrite=SubjectSetRewrite(
            children=[ComputedSubjectSet(relation="owner")])),
    ])]
    pair.jcfg.set_namespaces(rewritten)
    pair.tcfg.set_namespaces(port_namespaces(rewritten))
    assert pair.compare(["n:o#editor@u"])[0].membership == Membership.IS_MEMBER


def test_large_batch_splits_and_small_frontier():
    from keto_tpu.namespace import Namespace

    tuples = [f"n:o{i}#r@u{i}" for i in range(50)]
    queries = [f"n:o{i}#r@u{i}" for i in range(50)] + [f"n:o{i}#r@u{i + 1}" for i in range(30)]
    pair = Pair([Namespace(name="n")], tuples, 5, frontier_cap=16)
    got = pair.compare(queries)
    assert [r.allowed for r in got] == [True] * 50 + [False] * 30
    _assert_same_routing(pair)


def test_random_writes_stay_in_step():
    """Interleaved writes, deletes and checks on a random graph."""
    namespaces, tuples, queries, max_depth = SCENARIOS["random_monotone"]()
    pair = Pair(namespaces, tuples[:80], max_depth)
    rng = random.Random(5)
    for round_ in range(3):
        pair.write(tuples[80 + 20 * round_: 100 + 20 * round_])
        pair.delete(rng.sample(tuples[:80], 5))
        pair.compare(queries[:24], max_depth, pruning=False)
    # every write moves the store version: both engines refresh their
    # overlay and replay dirty rows on the host, with one build
    assert pair.port.stats["snapshot_builds"] == pair.jax.stats["snapshot_builds"] == 1
    assert pair.port.stats["incremental_merges"] == pair.jax.stats.get("incremental_merges", 0)
    _assert_same_routing(pair)


def test_unknown_vocabulary_and_subject_sets():
    namespaces, tuples, _queries, max_depth = SCENARIOS["cat_videos"]()
    pair = Pair(namespaces, tuples, max_depth)
    pair.compare([
        "ghost:o#r@u", "videos:/nowhere#view@cat lady", "videos:/cats#nothing@x",
        "videos:/cats/1.mp4#owner@(videos:/cats#owner)",
        "videos:/cats/1.mp4#owner@(videos:/cats#view)",
    ])
    _assert_same_routing(pair)


def test_check_is_member_raises_relation_errors():
    from keto_tpu.namespace import Namespace
    from keto_tpu.namespace.ast import Relation

    from keto_tpu_torch.errors import RelationNotFoundError

    pair = Pair([Namespace(name="n", relations=[Relation(name="known")])], ["n:o#rogue@u"], 5)
    assert pair.port.check_is_member(TTuple.from_string("n:o#rogue@u"))
    with pytest.raises(RelationNotFoundError):
        pair.port.check_is_member(TTuple.from_string("n:o#rogue@v"))
    # the direct hit is flagged too: an undeclared relation always replays
    assert pair.port.stats["host_cause"] == {"relation_not_found": 2}


def test_cuda_engine_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA engine is exercised by chip_smoke.py")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TorchCheckEngine(TMemory(), TConfig({}))


def test_cuda_kernel_wrappers_refuse_cpu_tensors():
    from keto_tpu_torch.engine import cuda_ops

    pack = torch.zeros(64, 4, dtype=torch.int32)
    obj, rels = torch.zeros(4, dtype=torch.int32), torch.zeros(4, 1, dtype=torch.int32)
    before = cuda_ops.launches["pair_probe"]
    with pytest.raises(ValueError, match="CUDA tensors"):
        cuda_ops.pair_probe(pack, obj, rels, probes=1, spb=1, n_vals=1)
    assert cuda_ops.launches["pair_probe"] == before


def test_import_boundary():
    """Importing the port, its engine, its serving plane (registry,
    resilience, batcher, check cache, daemon), its gRPC plane (the
    descriptors, messages, gRPC servers, clients and OpenAPI document), its
    asyncio read plane, its entry point, its tools, its scale tier (the
    columnar store and columns, the native encoders, the 1e7 generators),
    its OPL parser and namespace files, its Watch hub, its durable store
    (the SQLite persister, the dialects, the UUID mapping) and its fault
    points loads neither jax nor any module of keto_tpu."""
    code = (
        "import sys, runpy\n"
        "import keto_tpu_torch, keto_tpu_torch.__main__\n"
        "import keto_tpu_torch.engine.torch_engine, keto_tpu_torch.api.rest_server\n"
        "import keto_tpu_torch.engine.expand_kernel, keto_tpu_torch.engine.reverse_kernel\n"
        "import keto_tpu_torch.engine.closure, keto_tpu_torch.engine.closure_kernel\n"
        "import keto_tpu_torch.engine.filter_kernel, keto_tpu_torch.engine.closure_power\n"
        "import keto_tpu_torch.engine.snaptoken, keto_tpu_torch.tools.microbench\n"
        "import keto_tpu_torch.tools.microbench_feasibility, keto_tpu_torch.closure\n"
        "import keto_tpu_torch.registry, keto_tpu_torch.resilience\n"
        "import keto_tpu_torch.api.batcher, keto_tpu_torch.api.check_cache\n"
        "import keto_tpu_torch.api.daemon, keto_tpu_torch.native\n"
        "import keto_tpu_torch.storage.columnar, keto_tpu_torch.storage.columns\n"
        "import keto_tpu_torch.tools.scale\n"
        "import keto_tpu_torch.api.descriptors, keto_tpu_torch.api.messages\n"
        "import keto_tpu_torch.api.grpc_server, keto_tpu_torch.api.client\n"
        "import keto_tpu_torch.api.openapi, keto_tpu_torch.api.aio_server\n"
        "import keto_tpu_torch.opl, keto_tpu_torch.opl.parser, keto_tpu_torch.config\n"
        "import keto_tpu_torch.watch, keto_tpu_torch.watch.hub\n"
        "import keto_tpu_torch.faults, keto_tpu_torch.storage.sqlite\n"
        "import keto_tpu_torch.storage.dialect, keto_tpu_torch.storage.mapping\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'keto_tpu' or m.startswith('keto_tpu.'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": REPO},
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_no_jax_in_port_sources():
    roots = [os.path.join(REPO, "keto_tpu_torch"), os.path.join(REPO, "chip_smoke.py")]
    files = []
    for root in roots:
        if os.path.isfile(root):
            files.append(root)
        for d, _, names in os.walk(root):
            files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    assert len(files) > 10
    for path in files:
        with open(path, encoding="utf-8") as f:
            for line in f:
                s = line.strip()
                if s.startswith(("import ", "from ")):
                    mod = s.split()[1]
                    assert not mod.startswith(("jax", "keto_tpu.")), (path, s)
                    assert mod not in ("keto_tpu",), (path, s)


CSRC = os.path.join(REPO, "keto_tpu_torch", "csrc")
CUDA_FILES = sorted(n for n in os.listdir(CSRC) if n.endswith((".cu", ".cuh")))


@pytest.mark.parametrize("source", CUDA_FILES)
def test_kernel_sources_and_includes_are_hashed(source):
    """Every CUDA source is built and hashed, and every header it includes
    is in cuda_ops.HEADERS, so an edit to any of them names a new library
    (cuda_ops.library_path) and rebuilds it."""
    import re

    from keto_tpu_torch.engine import cuda_ops

    hashed = {p.name for p in cuda_ops.SOURCES + cuda_ops.HEADERS}
    assert source in hashed
    with open(os.path.join(CSRC, source), encoding="utf-8") as f:
        includes = re.findall(r'^\s*#\s*include\s+"([^"]+)"', f.read(), re.M)
    assert set(includes) <= {p.name for p in cuda_ops.HEADERS}, includes
