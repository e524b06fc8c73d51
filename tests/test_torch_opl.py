"""The port's Ory Permission Language parser (keto_tpu_torch/opl) and its
namespace-file configuration (keto_tpu_torch/config.py) held against
keto_tpu's, on the CPU.

  (a) `tokenize` and `parse` on tests/test_opl.py's full example, every
      source its error cases and fuzz corpus hold, and 500 sources
      mutated from the full example (tokens dropped, swapped or
      duplicated, from a numpy seed): equal token streams, equal
      `Namespace.to_dict()` lists, equal error messages, positions and
      rendered texts;
  (b) NamespaceFileManager over a temp directory of `.ts`, `.yaml`,
      `.json` and `.toml` files: equal loaded sets, hot reload on an
      mtime change, rollback with an equal `last_error`, a new
      `config_generation` on each load that succeeds and none on one
      that fails, the startup ConfigError, `file://` and `{location}`
      sources, and `Config.from_file` on yaml, json and toml;
  (c) a CPU TorchCheckEngine and keto_tpu's TPUCheckEngine under OPL
      namespaces read from the same `.ts` file: equal packed result
      vectors (launch counters included), verdicts equal to the host
      oracle's complete walk, equal routing counts, before and after a
      hot reload that rewrites a permit, and no rebuild after a reload
      that fails.

Tolerance: exact equality.
"""

import json
import os
import sys

import numpy as np
import pytest

from keto_tpu.config import Config as JConfig
from keto_tpu.config import ConfigError as JConfigError
from keto_tpu.config import NamespaceFileManager as JManager
from keto_tpu.engine.tpu_engine import TPUCheckEngine
from keto_tpu.ketoapi import RelationTuple as JTuple
from keto_tpu.opl import parse as jparse
from keto_tpu.opl import tokenize as jtokenize
from keto_tpu.storage import MemoryManager as JMemory

from keto_tpu_torch.config import Config as TConfig
from keto_tpu_torch.config import ConfigError as TConfigError
from keto_tpu_torch.config import NamespaceFileManager as TManager
from keto_tpu_torch.engine import ReferenceEngine as TReference
from keto_tpu_torch.engine.torch_engine import TorchCheckEngine
from keto_tpu_torch.ketoapi import RelationTuple as TTuple
from keto_tpu_torch.namespace.definitions import MemoryNamespaceManager
from keto_tpu_torch.opl import parse as tparse
from keto_tpu_torch.opl import tokenize as ttokenize
from keto_tpu_torch.storage import MemoryManager as TMemory

import test_opl
from test_opl import FULL_EXAMPLE

# the sources of tests/test_opl.py's parser cases, errors and all
LEFT_FOLD = """
class U implements Namespace {}
class D implements Namespace {
  related: { a: U[]  b: U[]  c: U[] }
  permits = {
    p: (ctx) => this.related.a.includes(ctx.subject) &&
                this.related.b.includes(ctx.subject) ||
                this.related.c.includes(ctx.subject),
  }
}
"""
CASES = {
    "full_example": FULL_EXAMPLE,
    "lexer_error": "/* unclosed comment",
    "unclosed_string": 'class A implements Namespace { related: { r: SubjectSet<A, "x >[] } }',
    "left_fold": LEFT_FOLD,
    "unknown_namespace": "class D implements Namespace {\n  related: { viewers: Nonexistent[] }\n}",
    "subject_set_relation": ('class G implements Namespace {}\nclass D implements Namespace {\n'
                             '  related: { viewers: SubjectSet<G, "members">[] }\n}'),
    "ttu_types": ("class G implements Namespace {}\nclass D implements Namespace {\n"
                  "  related: { parents: G[] }\n  permits = { view: (ctx) => "
                  "this.related.parents.traverse(p => p.permits.view(ctx)) }\n}"),
    "nesting_cap": ("class U implements Namespace {}\nclass D implements Namespace {\n"
                    "  related: { a: U[] }\n  permits = { p: (ctx) => " + "(" * 11
                    + "this.related.a.includes(ctx.subject)" + ")" * 11 + " }\n}\n"),
    "position": "class D implements Namespace { bogus }",
    "empty": "",
    "pathological_parens": ("class A implements Namespace { permits = { p: (ctx) => "
                            + "(" * 2000 + "ctx" + ")" * 2000 + " } }"),
    "pathological_classes": "class A implements Namespace {" * 500,
    **{f"fuzz_seed_{i}": s for i, s in enumerate(test_opl.TestParserFuzz.SEED_CORPUS)},
}
N_MUTANTS = 500


def tokens_of(toks):
    return [(t.typ.name, t.val, t.start, t.end) for t in toks]


def parsed(parse, source):
    """A parse as plain data: the namespaces' dicts, then each error's
    message, token and rendered text."""
    namespaces, errs = parse(source)
    return ([ns.to_dict() for ns in namespaces],
            [(e.msg, e.token.typ.name, e.token.val, e.token.start, e.token.end, str(e))
             for e in errs])


def assert_same_parse(source):
    assert tokens_of(ttokenize(source)) == tokens_of(jtokenize(source))
    got, want = parsed(tparse, source), parsed(jparse, source)
    assert got == want
    return got


# -- (a) the lexer and the parser -----------------------------------------------------


@pytest.mark.parametrize("case", sorted(CASES))
def test_parse_equals_keto_tpu(case):
    namespaces, errors = assert_same_parse(CASES[case])
    if case == "full_example":
        assert errors == [] and [n["name"] for n in namespaces] == \
            ["User", "Group", "Folder", "File"]
    if case in ("lexer_error", "unknown_namespace", "subject_set_relation", "ttu_types",
                "nesting_cap", "position"):
        assert errors, case


def _mutants(n, seed=2025):
    """Sources made from the full example's token stream: each drops,
    swaps or duplicates one to three tokens (a token keeps the blank that
    follows it)."""
    toks = [t for t in jtokenize(FULL_EXAMPLE) if t.typ.name != "EOF"]
    pieces = [FULL_EXAMPLE[:toks[0].start]] + [
        FULL_EXAMPLE[t.start:(toks[i + 1].start if i + 1 < len(toks) else len(FULL_EXAMPLE))]
        for i, t in enumerate(toks)]
    rng = np.random.default_rng(seed)
    for _ in range(n):
        p = list(pieces)
        for _ in range(int(rng.integers(1, 4))):
            i = int(rng.integers(1, len(p)))
            op = int(rng.integers(3))
            if op == 0:
                del p[i]
            elif op == 1:
                j = int(rng.integers(1, len(p)))
                p[i], p[j] = p[j], p[i]
            else:
                p.insert(i, p[i])
        yield "".join(p)


def test_mutated_sources_parse_equal_keto_tpu():
    with_errors = 0
    for source in _mutants(N_MUTANTS):
        _namespaces, errors = assert_same_parse(source)
        with_errors += bool(errors)
    # the mutations reach the error paths, and not only them
    assert 0 < with_errors < N_MUTANTS


# -- (b) namespace files ----------------------------------------------------------------


OPL_A = """
class User implements Namespace {}
class Team implements Namespace {
  related: { members: User[] }
}
"""
OPL_B = """
class Repo implements Namespace {
  related: {
    owners: User[]
    readers: (User | SubjectSet<Team, "members">)[]
  }
  permits = {
    read: (ctx: Context): boolean =>
      this.related.readers.includes(ctx.subject) || this.related.owners.includes(ctx.subject),
  }
}
"""
OPL_B2 = OPL_B.replace("|| this.related.owners.includes(ctx.subject)", "")
BROKEN = "class Repo implements Namespace { related: { owners: User[] "


def _write(path, text, bump=0.0):
    with open(path, "w") as f:
        f.write(text)
    if bump:
        st = os.stat(path)
        os.utime(path, (st.st_atime + bump, st.st_mtime + bump))


@pytest.fixture
def ns_dir(tmp_path):
    d = tmp_path / "namespaces"
    d.mkdir()
    _write(d / "a.keto.ts", OPL_A)
    _write(d / "b.keto.ts", OPL_B)
    _write(d / "c.yaml", "name: docs\nrelations:\n  - name: viewer\n")
    _write(d / "d.json", json.dumps([{"name": "videos", "relations": [{"name": "owner"}]},
                                     {"name": "groups", "id": 7}]))
    _write(d / "e.toml", 'name = "tickets"\n[[relations]]\nname = "assignee"\n')
    _write(d / "ignored.txt", "not a namespace file")
    return d


def loaded(manager):
    return sorted((ns.to_dict() for ns in manager.namespaces()), key=lambda d: d["name"])


@pytest.mark.parametrize("prefix", ["", "file://"])
def test_namespace_directory_equals_keto_tpu(ns_dir, prefix):
    t, j = TManager(prefix + str(ns_dir)), JManager(prefix + str(ns_dir))
    assert loaded(t) == loaded(j)
    assert [d["name"] for d in loaded(t)] == \
        ["Repo", "Team", "User", "docs", "groups", "tickets", "videos"]
    assert t.get_namespace_by_name("Repo").to_dict() == \
        j.get_namespace_by_name("Repo").to_dict()
    gen_t, gen_j = t.config_generation, j.config_generation
    # a reload that changes a permit
    _write(ns_dir / "b.keto.ts", OPL_B2, bump=5)
    assert loaded(t) == loaded(j)
    assert t.config_generation != gen_t and j.config_generation != gen_j
    assert t.last_error is None and j.last_error is None
    read = t.get_namespace_by_name("Repo").relation("read").to_dict()
    assert "owners" not in json.dumps(read)
    # a reload that fails: the previous set stays, the error is kept
    before = loaded(t)
    gen_t, gen_j = t.config_generation, j.config_generation
    _write(ns_dir / "b.keto.ts", BROKEN, bump=10)
    assert loaded(t) == loaded(j) == before
    assert t.config_generation == gen_t and j.config_generation == gen_j
    assert str(t.last_error) == str(j.last_error) and "could not parse" in str(t.last_error)
    assert type(t.last_error).__name__ == type(j.last_error).__name__ == "ConfigError"
    # and the repair loads again
    _write(ns_dir / "b.keto.ts", OPL_B, bump=15)
    assert loaded(t) == loaded(j) and t.last_error is None is j.last_error
    assert t.config_generation != gen_t


@pytest.mark.parametrize("name,text", [
    ("single.keto.ts", OPL_A + OPL_B),
    ("single.yaml", "- name: a\n- name: b\n  relations: [{name: r}]\n"),
    ("single.json", json.dumps({"name": "solo", "relations": [{"name": "r"}]})),
    ("single.toml", 'name = "solo"\n'),
    ("empty.yaml", ""),
])
def test_namespace_file_equals_keto_tpu(tmp_path, name, text):
    path = tmp_path / name
    _write(path, text)
    assert loaded(TManager(str(path))) == loaded(JManager(str(path)))


@pytest.mark.parametrize("name,text", [
    ("bad.keto.ts", BROKEN),
    ("bad.json", "{not json"),
    ("bad.ext", "x"),
])
def test_startup_parse_error_raises_config_error(tmp_path, name, text):
    path = tmp_path / name
    _write(path, text)
    with pytest.raises(TConfigError) as got:
        TManager(str(path))
    with pytest.raises(JConfigError) as want:
        JManager(str(path))
    assert str(got.value) == str(want.value)
    # and through the config, as `serve` reads it
    with pytest.raises(TConfigError):
        TConfig({"namespaces": {"location": f"file://{path}"}}).namespace_manager()


def test_missing_directory_raises(tmp_path):
    with pytest.raises(TConfigError) as got:
        TManager(str(tmp_path / "nowhere.ts"))
    with pytest.raises(JConfigError) as want:
        JManager(str(tmp_path / "nowhere.ts"))
    assert str(got.value) == str(want.value)


def test_config_namespace_sources(ns_dir):
    for raw in (str(ns_dir), f"file://{ns_dir}", {"location": f"file://{ns_dir}"}):
        t = TConfig({"namespaces": raw}).namespace_manager()
        j = JConfig({"namespaces": raw}).namespace_manager()
        assert isinstance(t, TManager) and loaded(t) == loaded(j)
    inline = [{"name": "videos", "relations": [{"name": "owner"}]}]
    t = TConfig({"namespaces": inline}).namespace_manager()
    assert isinstance(t, MemoryNamespaceManager)
    assert loaded(t) == loaded(JConfig({"namespaces": inline}).namespace_manager())
    with pytest.raises(TConfigError, match="invalid `namespaces`"):
        TConfig({"namespaces": 7}).namespace_manager()


CONFIG = {"dsn": "memory", "limit": {"max_read_depth": 7},
          "serve": {"read": {"host": "127.0.0.1", "port": 0}},
          "watch": {"poll_interval": 0.1, "buffer": 64, "heartbeat_s": 1.5}}


@pytest.mark.parametrize("ext,text", [
    ("yaml", "dsn: memory\nlimit:\n  max_read_depth: 7\nserve:\n  read:\n    host: 127.0.0.1\n"
             "    port: 0\nwatch:\n  poll_interval: 0.1\n  buffer: 64\n  heartbeat_s: 1.5\n"),
    ("yml", json.dumps(CONFIG)),  # JSON is YAML
    ("json", json.dumps(CONFIG)),
    ("toml", 'dsn = "memory"\n[limit]\nmax_read_depth = 7\n[serve.read]\nhost = "127.0.0.1"\n'
             'port = 0\n[watch]\npoll_interval = 0.1\nbuffer = 64\nheartbeat_s = 1.5\n'),
])
def test_config_from_file_equals_keto_tpu(tmp_path, ext, text):
    path = tmp_path / f"keto.{ext}"
    _write(path, text)
    got, want = TConfig.from_file(str(path)), JConfig.from_file(str(path))
    assert got._values == want._values == CONFIG
    assert got.max_read_depth() == want.max_read_depth() == 7


def test_config_from_file_refuses_other_extensions(tmp_path):
    path = tmp_path / "keto.ini"
    _write(path, "[x]")
    with pytest.raises(TConfigError, match="unknown config file extension"):
        TConfig.from_file(str(path))


def test_yaml_without_pyyaml_raises(tmp_path, monkeypatch):
    """PyYAML is imported only for a YAML file; without it a YAML config
    or namespace file raises, and a JSON config still loads."""
    monkeypatch.setitem(sys.modules, "yaml", None)
    path = tmp_path / "keto.yaml"
    _write(path, "dsn: memory\n")
    with pytest.raises(TConfigError, match="PyYAML"):
        TConfig.from_file(str(path))
    with pytest.raises(TConfigError, match="PyYAML"):
        TManager(str(path))
    _write(tmp_path / "keto.json", json.dumps(CONFIG))
    assert TConfig.from_file(str(tmp_path / "keto.json"))._values == CONFIG


# -- (c) the engine under OPL namespaces --------------------------------------------------


EDIT_OWNERS = "edit: (ctx: Context) => this.related.owners.includes(ctx.subject),"
EDIT_WIDE = ("edit: (ctx: Context) => this.related.owners.includes(ctx.subject) || "
             "this.related.viewers.includes(ctx.subject),")


def opl_tuples():
    """Folders of files with parents, groups of users, a group of viewers
    a folder, owners, viewers and siblings on some files."""
    out = []
    for g in range(4):
        out += [f"Group:g{g}#members@u{g * 4 + k}" for k in range(4)]
    for d in range(3):
        out.append(f"Folder:d{d}#viewers@(Group:g{d}#members)")
        for f in range(6):
            name = f"File:d{d}f{f}"
            out.append(f"{name}#parents@(Folder:d{d}#...)")
            if f % 2 == 0:
                out.append(f"{name}#owners@u{(d + f) % 16}")
            if f % 3 == 0:
                out.append(f"{name}#viewers@(Group:g3#members)")
            if f % 3 == 1:
                out.append(f"{name}#siblings@(File:d{d}f{(f + 1) % 6}#...)")
    return out


def opl_queries():
    qs = []
    for d in range(3):
        for f in range(6):
            for u in (0, 3, d * 4 + 1, (d + f) % 16, 13):
                for perm in ("view", "edit", "not", "rename"):
                    qs.append(f"File:d{d}f{f}#{perm}@u{u}")
    return qs


class OplPair:
    """Both engines over equal stores, each under the namespaces its own
    package reads from one `.ts` file."""

    def __init__(self, path):
        cfg = {"namespaces": {"location": f"file://{path}"}}
        self.jcfg, self.tcfg = JConfig(cfg), TConfig(cfg)
        self.jm, self.tm = JMemory(), TMemory()
        ts = opl_tuples()
        self.jm.write_relation_tuples([JTuple.from_string(s) for s in ts])
        self.tm.write_relation_tuples([TTuple.from_string(s) for s in ts])
        self.jax = TPUCheckEngine(self.jm, self.jcfg)
        self.port = TorchCheckEngine(self.tm, self.tcfg, device="cpu")

    def check(self, qs):
        th = self.port.check_batch_submit([TTuple.from_string(q) for q in qs])
        jh = self.jax.check_batch_submit([JTuple.from_string(q) for q in qs])
        assert th[0] == jh[0] == "batch"
        np.testing.assert_array_equal(th[1].numpy(), np.asarray(jh[1]))
        got, want = self.port.check_batch_resolve(th), self.jax.check_batch_resolve(jh)
        # the complete walk: the pruning one cuts the second traverse of
        # `view`'s AND, which reaches the folder's viewers again
        oracle = TReference(self.tm, self.tcfg, visited_pruning=False)
        for q, g, w in zip(qs, got, want):
            o = oracle.check_relation_tuple(TTuple.from_string(q))
            assert (g.error is None) == (w.error is None) == (o.error is None), q
            if g.error is None:
                assert g.membership.value == w.membership.value == o.membership.value, q
        for key in ("device_checks", "host_checks", "host_cause", "snapshot_builds"):
            assert self.port.stats[key] == self.jax.stats.get(key, {} if key == "host_cause"
                                                              else 0), key
        return [g.allowed for g in got]


def test_engine_under_opl_equals_keto_tpu_across_a_reload(tmp_path):
    path = tmp_path / "namespaces.keto.ts"
    _write(path, FULL_EXAMPLE)
    assert EDIT_OWNERS in FULL_EXAMPLE
    pair = OplPair(path)
    qs = opl_queries()
    before = pair.check(qs)
    assert pair.port.stats["snapshot_builds"] == 1 and any(before) and not all(before)
    # `edit` becomes owners || viewers: one rebuild, new verdicts
    _write(path, FULL_EXAMPLE.replace(EDIT_OWNERS, EDIT_WIDE), bump=5)
    after = pair.check(qs)
    assert pair.port.stats["snapshot_builds"] == 2
    assert after != before
    # a broken file: the previous set serves on, no rebuild
    _write(path, BROKEN, bump=10)
    assert pair.check(qs) == after
    assert pair.port.stats["snapshot_builds"] == 2
    assert "could not parse" in str(pair.tcfg.namespace_manager().last_error)
