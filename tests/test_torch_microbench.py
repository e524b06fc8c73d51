"""The port's microbenchmark primitives (keto_tpu_torch/tools, M1-M10)
against the TPU kernel bodies they replace.

The Pallas bodies are taken from tools/microbench_pallas.py and
tools/microbench_pallas_feasibility.py as they are: the nested functions
of each file's main() are executed in a namespace that binds jax, jnp, F,
CAP and a `pl` whose pallas_call runs in interpret mode, then called with
the files' own BlockSpecs (SMEM and VMEM both) on the same seeded arrays
the port's make_inputs draws. Tolerance: exact equality (integers, and an
exact float32 add). The hash probe's body does not trace (its int32
product overflows), so its plain version is held to a numpy uint64
formula of the same probe sequence instead.
"""

import ast
import contextlib
import functools
import io
import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from keto_tpu_torch.engine import cuda_ops
from keto_tpu_torch.tools import microbench as mb
from keto_tpu_torch.tools import microbench_feasibility as mf

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F, CAP = 256, 512
SPACES = {"smem": pltpu.SMEM, "vmem": pltpu.VMEM}
PL = types.SimpleNamespace(**{k: getattr(pl, k) for k in dir(pl) if not k.startswith("__")})
PL.pallas_call = functools.partial(pl.pallas_call, interpret=True)


def _main_body(tool: str) -> list:
    tree = ast.parse(open(os.path.join(REPO, "tools", tool)).read())
    return next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "main").body


def _pallas_functions(tool: str, **bind) -> dict:
    """The nested functions of the tool's main(), defined in a namespace
    binding jax, jnp, pl (interpret mode), pltpu and `bind`."""
    defs = [n for n in _main_body(tool) if isinstance(n, ast.FunctionDef)]
    ns = {"jax": jax, "jnp": jnp, "pl": PL, "pltpu": pltpu, **bind}
    exec(compile(ast.Module(body=defs, type_ignores=[]), tool, "exec"), ns)
    return ns


@pytest.fixture(scope="module")
def bodies():
    return _pallas_functions("microbench_pallas.py", F=F, CAP=CAP)


@pytest.fixture(scope="module")
def inputs():
    return mb.make_inputs(F, CAP)


def _call(kernel, out_shape, space, n_in, out_specs=None):
    spec = pl.BlockSpec(memory_space=SPACES[space])
    return PL.pallas_call(kernel, out_shape=out_shape, in_specs=[spec] * n_in,
                          out_specs=out_specs or spec)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_make_inputs_are_the_tools_draws():
    """make_inputs equals the tool's own draw statements, executed in its
    order from one generator."""
    draws = [s for s in _main_body("microbench_pallas.py")
             if isinstance(s, ast.Assign) and "rng.integers" in ast.unparse(s)]
    names = [s.targets[0].id for s in draws]
    assert names == ["tab", "idx", "buck", "prio", "keep", "vals", "keys", "kvals", "qk"]
    ns = {"np": np, "jnp": jnp, "F": F, "CAP": CAP, "rng": np.random.default_rng(0)}
    exec(compile(ast.Module(body=draws, type_ignores=[]), "draws", "exec"), ns)
    got = mb.make_inputs(F, CAP)
    for name in names:
        assert got[name].dtype == np.int32
        np.testing.assert_array_equal(got[name], np.asarray(ns[name]), err_msg=name)


@pytest.mark.parametrize("space", sorted(SPACES))
@pytest.mark.parametrize("dispatch", [mb.probe, mb.probe_smem], ids=["M1", "M2"])
def test_probe_matches_pallas(bodies, inputs, space, dispatch):
    want = _call(bodies["probe_kernel"], jax.ShapeDtypeStruct((F, 1), jnp.int32), space, 2)(
        inputs["tab"], inputs["idx"])
    got = dispatch(_t(inputs["tab"]), _t(inputs["idx"]))
    assert got.dtype == torch.int32 and got.shape == (F, 1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _probe_draw(draw: str, seed: int = 6):
    """(tab, idx) [CAP, 1], [F, 1] int32 with the indices at the table's
    two ends (each 0 or CAP - 1), all 0, or all CAP - 1."""
    rng = np.random.default_rng(seed)
    tab = rng.integers(0, 1 << 20, (CAP, 1), dtype=np.int32)
    if draw == "ends":
        idx = np.where(rng.random((F, 1)) < 0.5, 0, CAP - 1)
    else:
        idx = np.full((F, 1), 0 if draw == "all_first" else CAP - 1)
    return tab, idx.astype(np.int32)


@pytest.mark.parametrize("draw", ["ends", "all_first", "all_last"])
@pytest.mark.parametrize("space", sorted(SPACES))
@pytest.mark.parametrize("dispatch", [mb.probe, mb.probe_smem], ids=["M1", "M2"])
def test_probe_matches_pallas_on_edge_draws(bodies, space, dispatch, draw):
    """The plain version the card tests hold M1 and M2 to, against the
    Pallas body, on indices at both ends of the table and all equal."""
    tab, idx = _probe_draw(draw)
    want = _call(bodies["probe_kernel"], jax.ShapeDtypeStruct((F, 1), jnp.int32), space, 2)(
        tab, idx)
    got = dispatch(_t(tab), _t(idx))
    assert got.dtype == torch.int32 and got.shape == (F, 1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert set(np.unique(np.asarray(want))) <= {int(tab[0, 0]), int(tab[-1, 0])}


@pytest.mark.parametrize("space", sorted(SPACES))
@pytest.mark.parametrize("dispatch", [mb.scatmax, mb.scatmax_smem], ids=["M3", "M4"])
def test_scatmax_matches_pallas(bodies, inputs, space, dispatch):
    want = _call(bodies["scatmax_kernel"], jax.ShapeDtypeStruct((2 * F, 1), jnp.int32),
                 space, 2)(inputs["buck"], inputs["prio"])
    got = dispatch(_t(inputs["buck"]), _t(inputs["prio"]), n_out=2 * F)
    assert got.dtype == torch.int32 and got.shape == (2 * F, 1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _scatmax_draw(draw: str, seed: int = 5):
    """(buck, prio) [F, 1] int32 on the cases M3's bins and M4's slices
    are sensitive to: every update in one bucket, every update in one
    small range of buckets, priorities of both signs, priorities of 0
    beside positive ones."""
    rng = np.random.default_rng(seed)
    b = rng.integers(0, 2 * F, (F, 1), dtype=np.int32)
    p = rng.integers(1, 1 << 30, (F, 1), dtype=np.int32)
    if draw == "one_bucket":
        b[:] = 77
    elif draw == "one_range":
        b = rng.integers(64, 80, (F, 1), dtype=np.int32)
    elif draw == "negative":
        p = rng.integers(-(1 << 30), 1 << 30, (F, 1), dtype=np.int32)
    elif draw == "zero":
        p = np.where(rng.random((F, 1)) < 0.5, 0, p).astype(np.int32)
    return b, p


@pytest.mark.parametrize("draw", ["one_bucket", "one_range", "negative", "zero"])
@pytest.mark.parametrize("space", sorted(SPACES))
@pytest.mark.parametrize("dispatch", [mb.scatmax, mb.scatmax_smem], ids=["M3", "M4"])
def test_scatmax_matches_pallas_on_skewed_draws(bodies, space, dispatch, draw):
    """The plain version the card tests hold M3 and M4 to, against the
    Pallas body, on draws that pile updates onto one bucket or range or
    hold priorities that never beat the zero."""
    b, p = _scatmax_draw(draw)
    want = _call(bodies["scatmax_kernel"], jax.ShapeDtypeStruct((2 * F, 1), jnp.int32),
                 space, 2)(b, p)
    got = dispatch(_t(b), _t(p), n_out=2 * F)
    assert got.dtype == torch.int32 and got.shape == (2 * F, 1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if draw == "negative":
        assert (np.asarray(want) == 0).sum() > F  # negatives left their buckets at zero


@pytest.mark.parametrize("space", sorted(SPACES))
@pytest.mark.parametrize("dispatch", [mb.pack_onepass, mb.pack], ids=["M5", "M6"])
def test_pack_matches_pallas(bodies, inputs, space, dispatch):
    out_shape = (jax.ShapeDtypeStruct((F, 1), jnp.int32), jax.ShapeDtypeStruct((1, 1), jnp.int32))
    spec = pl.BlockSpec(memory_space=SPACES[space])
    call = _call(bodies["pack_kernel"], out_shape, space, 2,
                 out_specs=(spec, pl.BlockSpec(memory_space=pltpu.SMEM)))
    want_out, want_n = call(inputs["keep"], inputs["vals"])
    got_out, got_n = dispatch(_t(inputs["keep"]), _t(inputs["vals"]))
    assert got_out.shape == (F, 1) and got_n.shape == (1, 1)
    np.testing.assert_array_equal(got_out.numpy(), np.asarray(want_out))
    np.testing.assert_array_equal(got_n.numpy(), np.asarray(want_n))
    n = int(want_n[0, 0])
    assert 0 < n < F and not got_out[n:].any()  # zeros past the count


@pytest.mark.parametrize("kept", [0, 1], ids=["none", "all"])
@pytest.mark.parametrize("space", sorted(SPACES))
@pytest.mark.parametrize("dispatch", [mb.pack_onepass, mb.pack], ids=["M5", "M6"])
def test_pack_matches_pallas_on_edge_draws(bodies, inputs, space, dispatch, kept):
    """The plain version the card tests hold M5 and M6 to, against the
    Pallas body, with keep all 0 (every output 0, the count 0) and all 1
    (the values as they are, the count F)."""
    keep = np.full((F, 1), kept, np.int32)
    out_shape = (jax.ShapeDtypeStruct((F, 1), jnp.int32), jax.ShapeDtypeStruct((1, 1), jnp.int32))
    spec = pl.BlockSpec(memory_space=SPACES[space])
    call = _call(bodies["pack_kernel"], out_shape, space, 2,
                 out_specs=(spec, pl.BlockSpec(memory_space=pltpu.SMEM)))
    want_out, want_n = call(keep, inputs["vals"])
    got_out, got_n = dispatch(_t(keep), _t(inputs["vals"]))
    np.testing.assert_array_equal(got_out.numpy(), np.asarray(want_out))
    np.testing.assert_array_equal(got_n.numpy(), np.asarray(want_n))
    assert int(want_n[0, 0]) == kept * F
    np.testing.assert_array_equal(np.asarray(want_out), inputs["vals"] * kept)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pack_keeps_input_order_on_edge_counts(seed):
    """Empty, full and ragged columns: survivors in input order, zeros
    past the count."""
    rng = np.random.default_rng(seed)
    for n in (0, 1, 3, 4097):
        keep = (rng.random((n, 1)) < [0.0, 1.0, 0.5][seed]).astype(np.int32)
        vals = rng.integers(1, 1 << 20, (n, 1), dtype=np.int32)
        out, cnt = mb.pack(_t(keep), _t(vals))
        sel = vals[keep != 0]
        assert int(cnt[0, 0]) == sel.size
        np.testing.assert_array_equal(out.numpy()[: sel.size, 0], sel)
        assert not out[sel.size:].any()


def _hashprobe_numpy(keys, kvals, q):
    """The tool's probe sequence in uint64: h1 = k * 2654435761 mod 2^32,
    h2 = (k * 40503 mod 2^32) | 1, both masked to the table."""
    mask = np.uint64(keys.size - 1)
    k = q.reshape(-1).astype(np.uint32).astype(np.uint64)
    m32 = np.uint64(0xFFFFFFFF)
    h1 = (k * np.uint64(2654435761)) & m32 & mask
    h2 = (((k * np.uint64(40503)) & m32) | np.uint64(1)) & mask
    p2 = (h1 + h2) & mask
    kf, vf, qf = keys.reshape(-1), kvals.reshape(-1), q.reshape(-1)
    out = np.full(qf.size, -1, np.int32)
    arm0 = kf[h1] == qf
    arm1 = ~arm0 & (kf[p2] == qf)
    out[arm0] = vf[h1[arm0]]
    out[arm1] = vf[p2[arm1]]
    return out.reshape(q.shape), int(arm0.sum()), int(arm1.sum())


def test_hashprobe_body_does_not_trace(bodies, inputs):
    call = _call(bodies["hashprobe_kernel"], jax.ShapeDtypeStruct((F, 1), jnp.int32), "smem", 3)
    with pytest.raises(OverflowError):
        call(inputs["keys"], inputs["kvals"], inputs["qk"])


@pytest.mark.parametrize("negative", [False, True])
def test_hashprobe_matches_uint32_formula(inputs, negative):
    q = inputs["qk"] if not negative else -inputs["qk"] - 1
    keys = mb.plant_keys(inputs["keys"], q, 96)
    want, arm0, arm1 = _hashprobe_numpy(keys, inputs["kvals"], q)
    assert arm0 >= 64 and arm1 >= 32 and arm0 + arm1 >= 64
    got = mb.hashprobe(_t(keys), _t(inputs["kvals"]), _t(q))
    assert got.shape == (F, 1)
    np.testing.assert_array_equal(got.numpy(), want)
    # the tool's own draws: (almost) every query misses
    want, _, _ = _hashprobe_numpy(inputs["keys"], inputs["kvals"], inputs["qk"])
    got = mb.hashprobe(_t(inputs["keys"]), _t(inputs["kvals"]), _t(inputs["qk"]))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.fixture(scope="module")
def feasibility():
    return _pallas_functions("microbench_pallas_feasibility.py")


def test_add_matches_pallas(feasibility):
    t = mf.make_inputs("cpu")
    x = jnp.asarray(t["x"].numpy())
    want = PL.pallas_call(feasibility["add_kernel"],
                          out_shape=jax.ShapeDtypeStruct(x.shape, x.dtype))(x, jnp.ones_like(x))
    got = mf.add(t["x"], t["y"])
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_row_gather_matches_pallas(feasibility):
    """The TPU refuses this body's lowering; interpret mode runs it."""
    t = mf.make_inputs("cpu")
    idx, tab = jnp.asarray(t["idx"].numpy()), jnp.asarray(t["tab"].numpy())
    want = PL.pallas_call(feasibility["vgather_kernel"],
                          out_shape=jax.ShapeDtypeStruct((idx.shape[0], tab.shape[1]),
                                                         tab.dtype))(idx, tab)
    np.testing.assert_array_equal(mf.row_gather(t["idx"], t["tab"]).numpy(), np.asarray(want))


def test_block_gather_matches_pallas(feasibility):
    t = mf.make_inputs("cpu")
    want = feasibility["gather_blocks"](jnp.asarray(t["bidx"].numpy()),
                                        jnp.asarray(t["tab"].numpy()))
    got = mf.block_gather(t["bidx"], t["tab"], block_rows=mf.BLOCK[0])
    assert got.shape == (len(mf.BIDX) * 8, 128)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _lines(main, argv) -> list[dict]:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv) == 0
    return [json.loads(line) for line in buf.getvalue().splitlines()]


def test_microbench_main_on_cpu():
    before = dict(cuda_ops.launches)
    lines = _lines(mb.main, ["--device", "cpu", "--n", "1"])
    assert cuda_ops.launches == before  # the plain versions ran
    big = f"_F{mb.F_LARGE}"
    ops = ["probe", "probe_smem", "scatmax", "scatmax_smem", "pack_onepass", "pack", "hashprobe",
           "scatmax" + big, "pack_onepass" + big, "pack" + big,
           "torch_gather", "torch_scatter_max", "torch_masked_select",
           "torch_scatter_max" + big, "torch_masked_select" + big, "device"]
    assert [line["op"] for line in lines] == ops
    for line in lines:
        assert set(line) == {"op", "ms", "bound_ms", "note"}
        if line["op"] != "device":
            assert line["ms"] > 0 and 0 < line["bound_ms"] < 0.01, line
            assert ("F=1048576" in line["note"]) == line["op"].endswith(big)
    assert lines[-1]["note"].startswith("cpu")
    # the byte bounds at 2^20: 16 B an update for the scatter-max (b, p
    # and the [2F] output), 12 B an input for the compaction
    by_op = {line["op"]: line["bound_ms"] for line in lines}
    assert by_op["scatmax" + big] == pytest.approx(16 * mb.F_LARGE / 3.35e12 * 1e3)
    assert by_op["pack" + big] == pytest.approx((12 * mb.F_LARGE + 4) / 3.35e12 * 1e3)


def test_feasibility_main_on_cpu():
    before = dict(cuda_ops.launches)
    lines = _lines(mf.main, ["--device", "cpu"])
    assert cuda_ops.launches == before
    assert lines[0] == {"device": "cpu: the plain versions"}
    assert lines[1] == {"probe": "basic_kernel", "ok": True, "compile_s": 0.0}
    assert lines[2]["probe"] == "vector_int_indexing" and lines[2]["ok"] is True
    assert lines[3] == {"probe": "scalar_prefetch_block_gather", "ok": True, "block": [8, 128]}


@pytest.mark.parametrize("main", [mb.main, mf.main], ids=["microbench", "feasibility"])
def test_entry_points_default_to_the_card(main):
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py runs the entry points there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main([])


def test_ops_bounds_count_what_the_data_touches(inputs):
    by_op = {o.op: o for o in mb.ops(inputs, "cpu")}
    sectors = np.unique(inputs["idx"].reshape(-1) // 8).size
    assert by_op["probe"].nbytes == 8 * F + 32 * sectors
    assert by_op["hashprobe"].library is None and by_op["hashprobe"].bound_by == "bytes"
    for o in list(by_op.values()) + mf.ops("cpu"):
        assert o.kernel in cuda_ops.MICROBENCH_KERNELS
        assert o.bound_ms > 0
        got, want = o.run(), o.plain()
        for a, b in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            assert torch.equal(a, b), o.op


WRAPPER_CALLS = {
    "mb_probe": lambda t: cuda_ops.mb_probe(t, t),
    "mb_probe_smem": lambda t: cuda_ops.mb_probe_smem(t, t),
    "mb_scatmax": lambda t: cuda_ops.mb_scatmax(t, t, n_out=8),
    "mb_scatmax_smem": lambda t: cuda_ops.mb_scatmax_smem(t, t, n_out=8),
    "mb_pack_onepass": lambda t: cuda_ops.mb_pack_onepass(t, t),
    "mb_pack": lambda t: cuda_ops.mb_pack(t, t),
    "mb_hashprobe": lambda t: cuda_ops.mb_hashprobe(t, t, t),
    "mb_add": lambda t: cuda_ops.mb_add(t.float(), t.float()),
    "mb_row_gather": lambda t: cuda_ops.mb_row_gather(t[:, 0], t),
    "mb_block_gather": lambda t: cuda_ops.mb_block_gather(t[:, 0], t, block_rows=2),
}


@pytest.mark.parametrize("name", cuda_ops.MICROBENCH_KERNELS)
def test_wrappers_refuse_cpu_tensors(name):
    assert set(WRAPPER_CALLS) == set(cuda_ops.MICROBENCH_KERNELS)
    before = cuda_ops.launches[name]
    with pytest.raises(ValueError, match="CUDA tensors"):
        WRAPPER_CALLS[name](torch.zeros(8, 4, dtype=torch.int32))
    assert cuda_ops.launches[name] == before
