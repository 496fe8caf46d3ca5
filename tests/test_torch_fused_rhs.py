# The fused N2 RHS of the port (rmt_tpu_torch/ops/cuda_rhs.py): on the
# CPU the wrapper runs its plain PyTorch twin, held here to rmt_tpu's
# fused Pallas RHS (ops/pallas_rhs.py, interpret mode) in plain and df32
# mode, at M = B and at the stage-stacked M = 3B, with the bars of
# tests/test_fused_rhs.py, for the DME chemistry and for the CH4 one (the
# kernel is generated per chemistry). The generated CUDA kernels are held
# to the same twin on the card by chip_smoke.py.

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ch4_case
from dme_case import make_model_input
from rmt_tpu.models import homo as jhomo
from rmt_tpu.ops import pallas_rhs
from rmt_tpu.parallel import batch_params
from rmt_tpu_torch.convert import params_from_jax
from rmt_tpu_torch.kinetics.dsl import accurate_f32_math
from rmt_tpu_torch.models import homo as thomo
from rmt_tpu_torch.ops import cuda_rhs

B = 8


def _to32(tree):
    return jax.tree.map(lambda x: jnp.asarray(np.asarray(x, np.float32)),
                        tree)


def _make_setup(mi, t_base, B=B):
    """Per-member float32 leaves and a state mildly off the initial value
    (kinetics and stencils active), the same numbers for both packages."""
    jspec = jhomo.build_spec(mi, z_no=20, t_no=5)
    base = jhomo.build_params(mi)
    params, axes = batch_params(
        base, {"T0": jnp.asarray(t_base + np.linspace(-5.0, 5.0, B))})

    def derive(q):
        d = jhomo.feed_state(jspec, q)
        return d, jhomo.n2_initial_state(jspec, q, d)

    dB, y0B = jax.vmap(derive, in_axes=(axes,))(params)

    def bcast(val, ax):
        arr = jnp.asarray(val)
        return arr if ax == 0 else jnp.broadcast_to(arr[None],
                                                    (B,) + arr.shape)

    pB = {k: ({kk: bcast(vv, axes[k][kk]) for kk, vv in v.items()}
              if k == "kinetic_overrides" else bcast(v, axes[k]))
          for k, v in params.items()}
    pB32, dB32 = _to32(pB), _to32(dB)
    rng = np.random.default_rng(0)
    y = (np.asarray(y0B) * (1.0 + 0.05 * rng.uniform(size=y0B.shape))
         ).astype(np.float32)
    tspec = thomo.build_spec(mi)
    leaves = cuda_rhs.pack_leaves(
        params_from_jax(pB32, device="cpu", dtype=torch.float32),
        params_from_jax(dB32, device="cpu", dtype=torch.float32))
    return jspec, tspec, pB, dB, pB32, dB32, y, leaves


@pytest.fixture(scope="module")
def setup():
    return _make_setup(make_model_input(model="N2"), 523.0)


@pytest.fixture(scope="module")
def setup_ch4():
    return _make_setup(ch4_case.make_model_input(model="N2"), 973.0)


def _scaled_rel(got, ref):
    scale = np.maximum(np.abs(ref), 1e-3 * np.max(np.abs(ref)))
    return float(np.max(np.abs(np.asarray(got, np.float64) - ref) / scale))


def _stack3(y):
    return np.concatenate([y, y * 1.01, y * 0.99], axis=0).astype(np.float32)


@pytest.mark.parametrize("rows", ["B", "3B"])
@pytest.mark.parametrize("mode", [False, "df32"])
def test_twin_matches_pallas(setup, mode, rows):
    """tests/test_fused_rhs.py bar: 5e-5 of max(|ref|, 1e-3 max|ref|) --
    a few f32 ulps through the ~1e3-amplifying kinetics cancellation
    (prefix-scan order, species-sum order, libm)."""
    jspec, tspec, _, _, pB32, dB32, y, leaves = setup
    yy = y if rows == "B" else _stack3(y)
    ref = np.asarray(pallas_rhs.build_n2_fused(
        jspec, accurate_rates=mode, interpret=True)(
            None, jnp.asarray(yy), pB32, dB32), np.float64)
    rhs = cuda_rhs.build_n2_fused(tspec, accurate_rates=mode)
    before = dict(cuda_rhs.LAUNCHES)
    got = rhs(torch.as_tensor(yy), *leaves)
    assert cuda_rhs.LAUNCHES == before      # CPU tensors run the twin
    assert tuple(got.shape) == ref.shape and got.dtype == torch.float32
    assert _scaled_rel(got.numpy(), ref) < 5e-5


@pytest.mark.parametrize("rows", ["B", "3B"])
@pytest.mark.parametrize("mode", [False, "df32"])
def test_ch4_twin_matches_pallas(setup_ch4, mode, rows):
    """The second chemistry (3 species, 1 reaction, a concentration-based
    rate with an integer power) through the same generator path, at the
    DME bar."""
    jspec, tspec, _, _, pB32, dB32, y, leaves = setup_ch4
    assert tspec.var_no_n2 == 4 and y.shape == (B, 80)
    yy = y if rows == "B" else _stack3(y)
    ref = np.asarray(pallas_rhs.build_n2_fused(
        jspec, accurate_rates=mode, interpret=True)(
            None, jnp.asarray(yy), pB32, dB32), np.float64)
    got = cuda_rhs.build_n2_fused(tspec, accurate_rates=mode)(
        torch.as_tensor(yy), *leaves)
    assert tuple(got.shape) == ref.shape and got.dtype == torch.float32
    assert _scaled_rel(got.numpy(), ref) < 5e-5


@pytest.mark.parametrize("mode", [False, "df32"])
def test_ch4_kernel_source_is_generated(setup_ch4, mode):
    """The CUDA source generated for CH4 carries its own rate program
    (one rate, three species, the integer power as df_int_pow in df32
    mode) and differs from the DME one."""
    tspec = setup_ch4[1]
    src = cuda_rhs.kernel_source(tspec, accurate_rates=mode)
    assert "float co_re[3], mofri[3];" in src
    assert ("df r[1];" if mode else "float r[1];") in src
    assert ("const df v8 = df_int_pow(v5, 2);" if mode
            else "const float v8 = (v5 * v5);") in src
    dme = cuda_rhs.kernel_source(
        thomo.build_spec(make_model_input(model="N2")), accurate_rates=mode)
    assert src != dme and "n2_rhs_launch" in src


@pytest.mark.parametrize("mode", [False, "df32"])
def test_stage_stacked_equals_three_calls(setup, mode):
    """M = 3B stage-major stacking (member = row % B) equals three
    B-sized calls: bit for bit in df32 mode (pair arithmetic, no libm),
    within the 5e-5 bar in plain mode (vectorised and scalar libm paths
    may differ by an ulp)."""
    _, tspec, _, _, _, _, y, leaves = setup
    rhs = cuda_rhs.build_n2_fused(tspec, accurate_rates=mode)
    y3 = torch.as_tensor(_stack3(y))
    out3 = rhs(y3, *leaves).numpy()
    for s in range(3):
        one = rhs(y3[s * B:(s + 1) * B], *leaves).numpy()
        if mode == "df32":
            np.testing.assert_array_equal(out3[s * B:(s + 1) * B], one)
        else:
            assert _scaled_rel(out3[s * B:(s + 1) * B], one) < 5e-5


def test_df32_twin_tracks_f64_reference(setup):
    """The df32 twin stays as close to the float64 RHS as rmt_tpu's df32
    path does (tests/test_fused_rhs.py: within 2x, or 2e-6)."""
    jspec, tspec, pB, dB, pB32, dB32, y, leaves = setup
    rhs64 = jhomo.make_n2_rhs(jspec)
    p64 = jax.tree.map(lambda x: jnp.asarray(x, jnp.float64), pB)
    d64 = jax.tree.map(lambda x: jnp.asarray(x, jnp.float64), dB)
    ref64 = np.asarray(jax.vmap(
        lambda y_, p_, d_: rhs64(0.0, y_, p_, d_), in_axes=(0, 0, 0))(
            jnp.asarray(y, jnp.float64), p64, d64))
    xla = np.asarray(jhomo.make_n2_rhs_b(jspec, accurate_rates="df32")(
        jnp.zeros((B,)), jnp.asarray(y), pB32, dB32), np.float64)
    got = cuda_rhs.build_n2_fused(tspec, accurate_rates="df32")(
        torch.as_tensor(y), *leaves).numpy()
    err_port = _scaled_rel(got, ref64)
    err_xla = _scaled_rel(xla, ref64)
    assert err_port < max(2.0 * err_xla, 2e-6), (err_port, err_xla)


def test_operation_count_follows_the_rate_program(setup, setup_ch4):
    """The roofline's operation count walks the traced rate program: the
    CH4 program is two plain operations (a square and a product), a pair
    operation counts its error-free transforms (a pair product 24, so the
    square and the product are 48), and the DME chain in df32 mode is
    several times the plain count."""
    dme, ch4 = setup[1], setup_ch4[1]
    g_plain, _ = cuda_rhs.trace_rates(ch4, False)
    g_df, _ = cuda_rhs.trace_rates(ch4, True)
    dag = lambda g: sum(cuda_rhs._node_ops(*node) for node in g.nodes)
    assert dag(g_plain) == 2 and dag(g_df) == 48
    counts = {(name, mode): cuda_rhs.operation_count(spec, mode)
              for name, spec in (("dme", dme), ("ch4", ch4))
              for mode in (False, "df32")}
    assert counts["ch4", False] < counts["dme", False]
    assert counts["dme", "df32"] > 5 * counts["dme", False]
    rhs = cuda_rhs.build_n2_fused(dme, accurate_rates="df32")
    assert rhs.operations() == counts["dme", "df32"]


def test_wrapper_checks_rows():
    spec = thomo.build_spec(make_model_input(model="N2"))
    rhs = cuda_rhs.build_n2_fused(spec)
    leaves1 = torch.zeros((17, 4))
    leaves2 = torch.zeros((2, 6, 4))
    with pytest.raises(ValueError, match="multiple"):
        rhs(torch.zeros((6, 140)), leaves1, leaves2)
    with pytest.raises(ValueError, match="accurate_rates"):
        cuda_rhs.build_n2_fused(spec, accurate_rates=True)


# -- the kernel's tile (layout arithmetic the CUDA kernel runs on) ------------

def _warp_conflicts(geo, z_no, upwind):
    """Bank conflicts of the kernel's reads s_y[tx][s*z_no + zn] (or of
    the upwind node max(zn - 1, 0)) over every warp of a block: blockDim
    (mt, z_no), so thread id zn*mt + tx; two lanes conflict when they read
    different addresses in one of the 32 banks."""
    worst = 0
    tid = np.arange(geo.threads)
    tx, zn = tid % geo.mt, tid // geo.mt
    col = np.maximum(zn - 1, 0) if upwind else zn
    for s in range(geo.pitch // z_no):
        addr = tx * geo.pitch + s * z_no + col
        for w in range(0, geo.threads, 32):
            a = np.unique(addr[w:w + 32])
            worst = max(worst, int(np.bincount(a % 32).max()))
    return worst


@pytest.mark.parametrize("n, z_no, mt, want", [
    (140, 20, 16, (16, 320, 142, 4)),   # DME, plain
    (140, 20, 32, (32, 640, 141, 4)),   # DME, df32
    (80, 20, 16, (16, 320, 82, 4)),     # CH4
    (147, 21, 16, (16, 336, 150, 1)),   # rows of 588 bytes: 4-byte copies
    (500, 100, 16, (8, 800, 500, 4)),   # a long bed: fewer rows a block
])
def test_tile_geometry(n, z_no, mt, want):
    """Rows a block, threads, pitch and copy width; at most 1024 threads
    and 48 KB of static shared memory; 16-byte copies exactly where a row
    is a multiple of 16 bytes (a block's span then starts 16-byte
    aligned); the pitch keeps a warp's reads of its nodes and of their
    upwind nodes free of bank conflicts."""
    geo = cuda_rhs.tile_geometry(n, z_no, member_rows=43, mt=mt)
    assert (geo.mt, geo.threads, geo.pitch, geo.vec) == want
    assert geo.threads <= 1024 and geo.smem_bytes <= 48 * 1024
    assert geo.pitch >= n and (geo.vec == 4) == (n * 4 % 16 == 0)
    assert geo.smem_bytes == 4 * (2 * geo.mt * geo.pitch
                                  + (z_no + 43) * geo.mt)
    assert _warp_conflicts(geo, z_no, upwind=False) == 1
    assert _warp_conflicts(geo, z_no, upwind=True) == 1


def test_tile_geometry_rejects():
    with pytest.raises(ValueError, match="multiple"):
        cuda_rhs.tile_geometry(141, 20)
    with pytest.raises(ValueError, match="power of two"):
        cuda_rhs.tile_geometry(140, 20, mt=12)
    with pytest.raises(ValueError, match="no tile"):
        cuda_rhs.tile_geometry(20 * 2048, 2048)


@pytest.mark.parametrize("n, z_no", [(140, 20), (147, 21)])
@pytest.mark.parametrize("rows", ["full", "ragged"])
def test_staging_map_covers_each_element_once(n, z_no, rows):
    """The copies of a block cover every float of its span of y exactly
    once, each landing in its row and column of the padded tile, for a
    full tile and for a ragged last one (M = 300 rows at mt = 16: 12)."""
    geo = cuda_rhs.tile_geometry(n, z_no)
    r = geo.mt if rows == "full" else 300 % geo.mt
    src, dst = cuda_rhs.staging_map(geo, n, r)
    assert np.array_equal(np.sort(src), np.arange(r * n))
    assert len(np.unique(dst)) == r * n
    assert np.array_equal(dst // geo.pitch, src // n)
    assert np.array_equal(dst % geo.pitch, src % n)
    assert dst.max() < geo.mt * geo.pitch
    if geo.vec == 4:      # each 16-byte copy stays inside one row
        assert np.all(src.reshape(-1, 4)[:, 0] % 4 == 0)
        assert np.all(np.ptp(src.reshape(-1, 4) // n, axis=1) == 0)


@pytest.mark.parametrize("mode", [False, "df32"])
def test_kernel_source_carries_its_geometry(mode):
    """The generated kernel's tile constants are spec_geometry's: 16 rows
    a block in plain mode, 32 in df32 mode, and the launch takes the copy
    width the wrapper chose."""
    spec = thomo.build_spec(make_model_input(model="N2"))
    geo = cuda_rhs.spec_geometry(spec, mode)
    assert geo.mt == (32 if mode else 16)
    src = cuda_rhs.kernel_source(spec, accurate_rates=mode)
    for line in (f"constexpr int MT = {geo.mt};",
                 f"constexpr int PITCH = {geo.pitch};",
                 "int M, int B, int vec, void* stream)",
                 "n2_rhs_kernel<4><<<"):
        assert line in src
    rhs = cuda_rhs.build_n2_fused(spec, accurate_rates=mode)
    assert rhs.geometry == geo


B_RAGGED = 37


@pytest.fixture(scope="module")
def setup_ragged():
    return _make_setup(make_model_input(model="N2"), 523.0, B_RAGGED)


@pytest.mark.parametrize("rows", ["B", "3B"])
@pytest.mark.parametrize("mode", [False, "df32"])
def test_twin_matches_pallas_at_a_ragged_count(setup_ragged, mode, rows):
    """B = 37 members: a multiple of neither the kernel's 16- and 32-row
    tiles nor the TPU kernel's block; the twin stays at the bar of
    test_twin_matches_pallas."""
    jspec, tspec, _, _, pB32, dB32, y, leaves = setup_ragged
    yy = y if rows == "B" else _stack3(y)
    ref = np.asarray(pallas_rhs.build_n2_fused(
        jspec, accurate_rates=mode, interpret=True)(
            None, jnp.asarray(yy), pB32, dB32), np.float64)
    got = cuda_rhs.build_n2_fused(tspec, accurate_rates=mode)(
        torch.as_tensor(yy), *leaves)
    assert tuple(got.shape) == ref.shape == (len(yy), 140)
    assert _scaled_rel(got.numpy(), ref) < 5e-5


@pytest.mark.parametrize("chem", ["dme", "ch4"])
def test_accurate_math_kernel_source(setup, setup_ch4, monkeypatch, chem):
    """The plain mode's accurate-math variant: its generated source
    differs from the native one (it names the setting, so a build for one
    setting never serves the other, and carries accurate_math's device
    functions; the DME program calls them where it called expf, logf and
    log10f, and expands its integer powers into products), is the same
    text on every call, and build_n2_fused follows the DSL's switch as
    it stands when the function is made."""
    tspec = (setup if chem == "dme" else setup_ch4)[1]
    native = cuda_rhs.kernel_source(tspec, accurate_math=False)
    am = cuda_rhs.kernel_source(tspec, accurate_math=True)
    assert am != native
    assert am == cuda_rhs.kernel_source(tspec, accurate_math=True)
    assert "// accurate f32 math: on" in am
    assert "// accurate f32 math: off" in native
    assert "am_pow(float x, float y)" in am and "am_pow(" not in native
    if chem == "dme":
        for fn in ("am_exp(", "am_log(", "am_log10(", "am_pow("):
            assert am.count(fn) > 1, fn
        body = am[am.index("void rates("):]
        assert "expf(" not in body and "logf(" not in body
        assert "powf(" not in body
    monkeypatch.setenv("RMT_TORCH_ACCURATE_F32", "1")
    rhs = cuda_rhs.build_n2_fused(tspec)
    assert rhs.kernel_name == "n2_rhs_plain_am" and rhs.source() == am
    ops_am = rhs.operations()
    with accurate_f32_math(False):
        assert cuda_rhs.build_n2_fused(tspec).kernel_name == "n2_rhs_plain"
    monkeypatch.setenv("RMT_TORCH_ACCURATE_F32", "0")
    # the function keeps the setting it was made with
    assert rhs.source() == am and rhs.accurate_math
    assert cuda_rhs.build_n2_fused(tspec).source() == native
    ops = cuda_rhs.operation_count(tspec)
    # CH4's program calls no transcendental
    assert ops_am > ops if chem == "dme" else ops_am == ops


@pytest.mark.parametrize("rows", ["B", "3B"])
def test_accurate_math_twin_matches_pallas(setup, rows):
    """rmt_tpu's fused Pallas kernel traces the DSL through its accurate
    shim (RMT_TPU_ACCURATE_F32, on by default): the port's accurate-math
    twin stays at test_twin_matches_pallas's bar of it, and runs
    accurate_math's algorithms, not the native ops, whatever the switch
    says. (Both twins sit about 3e-6 from the Pallas kernel: prefix-scan
    and species-sum order and PyTorch's number / tensor outweigh the
    libm's ulps here.)"""
    jspec, tspec, _, _, pB32, dB32, y, leaves = setup
    yy = y if rows == "B" else _stack3(y)
    ref = np.asarray(pallas_rhs.build_n2_fused(
        jspec, accurate_rates=False, interpret=True)(
            None, jnp.asarray(yy), pB32, dB32), np.float64)
    with accurate_f32_math(True):
        rhs = cuda_rhs.build_n2_fused(tspec)
    with accurate_f32_math(False):
        native = cuda_rhs.build_n2_fused(tspec)(torch.as_tensor(yy), *leaves)
    got = rhs(torch.as_tensor(yy), *leaves)
    assert not torch.equal(got, native)
    assert _scaled_rel(got.numpy(), ref) < 5e-5
