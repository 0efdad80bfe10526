"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs an NVIDIA GPU and the CUDA toolkit: it carries the
``cuda`` marker and skips (inside the fixture, never at import) where
``torch.cuda.is_available()`` is false.  On a machine with a card:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

(``--noconftest``: tests/conftest.py sets up JAX, which this file does not use.)

The comparison is bitwise: each kernel repeats its plain version's
arithmetic in the same order, built without fast-math or FMA contraction.
"""

import numpy as np
import pytest
import torch

from stencil_tpu_torch.core.dim3 import Dim3
from stencil_tpu_torch.models.astaroth import AstarothSim
from stencil_tpu_torch.models.jacobi import Jacobi3D
from stencil_tpu_torch.ops import halo_blend as hb
from stencil_tpu_torch.ops import jacobi_kernels as jk
from stencil_tpu_torch.ops import pack as pk
from stencil_tpu_torch.ops import stream as st

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    return torch.device("cuda")


def _rand(shape, seed, dev):
    return torch.from_numpy(np.random.default_rng(seed).random(shape).astype(np.float32)).to(dev)


@pytest.mark.parametrize("k", [1, 2, 3])
def test_wrap_kernel_equals_plain(dev, k):
    block = _rand((66, 70, 130), 1, dev)
    before = jk.jacobi_wrap_step.launches
    got = jk.jacobi_wrap_step(block, k)
    torch.cuda.synchronize()
    assert jk.jacobi_wrap_step.launches == before + k
    assert torch.equal(got, jk.jacobi_wrap_step_plain(block, k))


def test_plane_kernel_equals_plain(dev):
    gs = (130, 140, 260)
    blocks = _rand((2, 66, 70, 130), 2, dev)
    origins = torch.tensor([[64, 0, 128], [0, 68, 0]], dtype=torch.int32, device=dev)
    d2 = torch.stack([jk.yz_dist2_plane(int(o[1]), int(o[2]), (68, 128), gs, dev) for o in origins])
    got = jk.jacobi_plane_step(blocks, origins, d2, gs)
    torch.cuda.synchronize()
    assert torch.equal(got, jk.jacobi_plane_step_plain(blocks, origins, d2, gs))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.bfloat16, torch.uint8])
@pytest.mark.parametrize("axis", [0, 1, 2])
def test_blend_kernel_equals_plain(dev, axis, dtype):
    blocks = (_rand((3, 17, 19, 23), 3, dev) * 100).to(dtype)
    for r, pos in ((1, 0), (2, 5), (3, blocks.shape[1 + axis] - 3)):
        shape = list(blocks.shape)
        shape[1 + axis] = r
        slab = (_rand(shape, 4 + r, dev) * 100).to(dtype)
        want = hb.blend_slab_plain(blocks.clone(), slab, axis, pos)
        got = hb.blend_slab(blocks.clone(), slab, axis, pos)
        torch.cuda.synchronize()
        assert torch.equal(got, want)


def _wavefront_case(dev, m, s_off, ring, slabs, z_valid=None):
    """Kernel and plain version of one wavefront call over 2 ragged blocks;
    returns both results and the valid-region slices."""
    Xr, Yr, Z = 22, 26, 128 if ring else 30
    gs = (2 * (Xr - 2 * s_off) + 3, 2 * (Yr - 2 * s_off), 2 * Z)
    raw = _rand((2, Xr, Yr, Z), 7, dev)
    org = torch.tensor([[5, 0, 7], [gs[0] - 3, Yr - 2 * s_off, 0]], dtype=torch.int32, device=dev)
    zs = _rand((2, Xr, 2 * s_off, Yr), 8, dev) if slabs else None
    if ring:
        d2 = torch.stack([jk.zring_dist2_plane(int(o[1]) - s_off, int(o[2]), s_off, Yr, Z, gs, dev)
                          for o in org])
        args = (raw, m, org, d2, gs, zs)
        kw = dict(interior_offset=s_off)
        fn, plain, zsl = jk.jacobi_zring_wavefront_step, jk.jacobi_zring_wavefront_step_plain, slice(None)
    else:
        d2 = torch.stack([jk.yz_dist2_plane(int(o[1]) - s_off, int(o[2]) - s_off, (Yr, Z), gs, dev)
                          for o in org])
        args = (raw, m, org, d2, gs)
        kw = dict(interior_offset=s_off, z_slabs=zs, z_valid=z_valid)
        fn, plain = jk.jacobi_shell_wavefront_step, jk.jacobi_shell_wavefront_step_plain
        zsl = slice(s_off, (z_valid or Z) - s_off)
    before = fn.launches
    got = fn(*args, **kw)
    torch.cuda.synchronize()
    assert fn.launches == before + 1  # m levels in one launch
    want = plain(*args, **kw)
    if not slabs:
        got, want = (got, None), (want, None)
    return got, want, slice(s_off, -s_off), zsl


@pytest.mark.parametrize("m,s_off", [(1, 1), (2, 2), (2, 3), (3, 4)])
@pytest.mark.parametrize("slabs", [False, True])
def test_shell_wavefront_kernel_equals_plain(dev, m, s_off, slabs):
    got, want, S, zsl = _wavefront_case(dev, m, s_off, False, slabs, z_valid=27)
    assert torch.equal(got[0][:, S, S, zsl], want[0][:, S, S, zsl])
    if slabs:
        assert torch.equal(got[1][:, S, :, S], want[1][:, S, :, S])


@pytest.mark.parametrize("m,s_off", [(1, 1), (2, 2), (2, 3), (3, 4)])
def test_zring_wavefront_kernel_equals_plain(dev, m, s_off):
    got, want, S, zsl = _wavefront_case(dev, m, s_off, True, True)
    assert torch.equal(got[0][:, S, S], want[0][:, S, S])
    assert torch.equal(got[1][:, S, :, S], want[1][:, S, :, S])


@pytest.mark.parametrize("n,X,Y,Z", [(1, 2, 3, 5), (3, 7, 33, 70), (8, 16, 40, 129)])
@pytest.mark.parametrize("faces", ["random", "self"])
def test_slab_kernel_equals_plain(dev, n, X, Y, Z, faces):
    """Ragged blocks (partial tiles in y and z, grid-strided planes), random
    face slabs or each block's own faces; origins past gx wrap."""
    gs = (n * X + 3, 2 * Y + 1, 3 * Z)
    block = _rand((n, X, Y, Z), 50, dev)
    if faces == "self":
        slabs = [t.contiguous() for t in (block[:, -1], block[:, 0], block[:, :, -1], block[:, :, 0],
                                          block[..., -1], block[..., 0])]
    else:
        slabs = [_rand((n,) + s, 51 + i, dev)
                 for i, s in enumerate(((Y, Z), (Y, Z), (X, Z), (X, Z), (X, Y), (X, Y)))]
    org = torch.tensor([[(b * X + 2) % gs[0], (5 * b) % gs[1], (7 * b) % gs[2]] for b in range(n)],
                       dtype=torch.int32, device=dev)
    d2 = torch.stack([jk.yz_dist2_plane(int(o[1]), int(o[2]), (Y, Z), gs, dev) for o in org])
    before = jk.jacobi_slab_step.launches
    got = jk.jacobi_slab_step(block, *slabs, org, d2, gs)
    torch.cuda.synchronize()
    assert jk.jacobi_slab_step.launches == before + 1  # all blocks in one launch
    assert torch.equal(got, jk.jacobi_slab_step_plain(block, *slabs, org, d2, gs))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.bfloat16, torch.uint8])
@pytest.mark.parametrize("axis", [0, 1, 2])
def test_blend_dynamic_kernel_equals_plain(dev, axis, dtype):
    """Per-block offsets as the uneven exchange makes them (the last block
    differs), every offset of a row of blocks, and an offset past the end
    (clamped)."""
    blocks = (_rand((4, 17, 19, 23), 60, dev) * 100).to(dtype)
    ext = blocks.shape[1 + axis]
    for r in (1, 2, 3):
        shape = list(blocks.shape)
        shape[1 + axis] = r
        slab = (_rand(shape, 61 + r, dev) * 100).to(dtype)
        for pos in ([ext - r] * 3 + [ext - r - 4], [0, 5, ext - r, ext + 9]):
            p = torch.tensor(pos, dtype=torch.int32, device=dev)
            before = hb.blend_slab_dynamic.launches
            got = hb.blend_slab_dynamic(blocks.clone(), slab, axis, p)
            torch.cuda.synchronize()
            assert hb.blend_slab_dynamic.launches == before + 1
            assert torch.equal(got, hb.blend_slab_dynamic_plain(blocks.clone(), slab, axis, p))


def test_model_routes_agree_on_card(dev):
    wrap = Jacobi3D(32, 32, 32, kernel_impl="cuda")
    shell = Jacobi3D(32, 32, 32, kernel_impl="cuda", pallas_path="shell")
    shell.dd.set_partition(2, 2, 2)
    wavefront = Jacobi3D(32, 32, 32, kernel_impl="cuda")
    wavefront.dd.set_partition(2, 2, 2)
    slab = Jacobi3D(32, 32, 32, kernel_impl="cuda", pallas_path="slab")
    slab.dd.set_partition(2, 2, 2)
    ref = Jacobi3D(32, 32, 32)
    for m in (wrap, shell, wavefront, slab, ref):
        m.realize()
        m.step(6)
    assert wavefront._pallas_path == "wavefront" and slab._pallas_path == "slab"
    assert np.array_equal(wrap.temperature(), shell.temperature())
    assert np.array_equal(wrap.temperature(), wavefront.temperature())
    assert np.array_equal(wrap.temperature(), slab.temperature())
    np.testing.assert_allclose(wrap.temperature(), ref.temperature(), rtol=1e-6)


def test_uneven_routes_agree_on_card(dev):
    """33^3 over 2x2x2 (17 + 16 cells a side): auto (the plain wavefront),
    shell and the torch engine against one unpadded subdomain."""
    wrap = Jacobi3D(33, 33, 33, kernel_impl="cuda")
    runs = [Jacobi3D(33, 33, 33, kernel_impl="cuda", **kw) for kw in ({}, {"pallas_path": "shell"})]
    ref = Jacobi3D(33, 33, 33)
    for m in runs + [ref]:
        m.dd.set_partition(2, 2, 2)
    for m in [wrap] + runs + [ref]:
        m.realize()
        m.step(7)
    assert runs[0]._pallas_path == "wavefront" and not runs[0]._wavefront_z_slabs
    assert runs[0].dd.padded()
    for m in runs:
        assert np.array_equal(m.temperature(), wrap.temperature())
    np.testing.assert_allclose(ref.temperature(), wrap.temperature(), rtol=1e-6)


# --- the shell packs of the packed exchange routes (csrc/pack.cu) ------------------------

PACKS = {"z": (2, pk.pack_zshell_pallas, pk.pack_zshell_pallas_plain, pk.unpack_zshell_pallas,
               pk.unpack_zshell_pallas_plain),
         "y": (1, pk.pack_yshell_pallas, pk.pack_yshell_pallas_plain, pk.unpack_yshell_pallas,
               pk.unpack_yshell_pallas_plain)}


def _hold_packs(axis, blocks, windows, seed):
    """Each pack and unpack kernel against its plain version at each
    ``(start, depth)`` window: bitwise, one launch a call."""
    _, pack, pack_plain, unpack, unpack_plain = PACKS[axis]
    for start, depth in windows:
        before = (pack.launches, unpack.launches)
        buf = pack(blocks, start, depth)
        torch.cuda.synchronize()
        assert torch.equal(buf, pack_plain(blocks, start, depth))
        new = (_rand(tuple(buf.shape), seed + start, blocks.device) * 100).to(blocks.dtype)
        got = unpack(blocks.clone(), new, start, depth)
        torch.cuda.synchronize()
        assert torch.equal(got, unpack_plain(blocks.clone(), new, start, depth))
        assert (pack.launches, unpack.launches) == (before[0] + 1, before[1] + 1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.bfloat16, torch.uint8])
@pytest.mark.parametrize("axis", ["z", "y"])
def test_shell_pack_kernels_equal_plain(dev, axis, dtype):
    """Ragged blocks, one and three at once, windows at both ends and inside."""
    blocks = (_rand((3, 17, 19, 23), 70, dev) * 100).to(dtype)
    ext = blocks.shape[1 + PACKS[axis][0]]
    windows = ((0, 1), (5, 3), (ext - 3, 3), (0, ext))
    _hold_packs(axis, blocks, windows, 71)
    _hold_packs(axis, blocks[1].contiguous(), windows, 72)


@pytest.mark.parametrize("axis", ["z", "y"])
def test_shell_pack_kernels_at_main_path_shapes(dev, axis):
    """Astaroth's plane route at 512^3 on 2x2x2: 8 blocks of 262^3, the
    radius-3 shell's four windows."""
    blocks = _rand((8, 262, 262, 262), 73, dev)
    _hold_packs(axis, blocks, ((256, 3), (3, 3), (0, 3), (259, 3)), 74)


def test_astaroth_packed_routes_agree_on_card(dev):
    """The plane route under every exchange route, 2 quantities on 2x2x2:
    bitwise equal to direct; the pallas routes launch the pack kernels."""
    from stencil_tpu_torch.kernels import ledger
    from stencil_tpu_torch.ops.exchange import EXCHANGE_ROUTES

    fields = {}
    for route in EXCHANGE_ROUTES:
        m = AstarothSim(32, 32, 32, num_quantities=2, subdomains=8, kernel_impl="cuda",
                        schedule="per-step", exchange_route=route)
        m.realize()
        ledger.reset_launch_counts()
        m.step(5)
        counts = ledger.launch_counts()
        fields[route] = [m.field(i) for i in range(2)]
        want = 2 * 2 * 5 if route.endswith("pallas") else 0  # 2 fields x 2 directions a step
        assert counts["pack_zshell_pallas"] == counts["unpack_zshell_pallas"] == want
        assert counts["pack_yshell_pallas"] == (want if route == "yzpack_pallas" else 0)
    for route in EXCHANGE_ROUTES[1:]:
        for got, ref in zip(fields[route], fields["direct"]):
            assert np.array_equal(got, ref), route


# --- the stream kernels: traced user kernels, emitted into csrc/stream_*.cu -----------


def _mean6(views, info):
    return {n: (v.sh(-1, 0, 0) + v.sh(0, -1, 0) + v.sh(0, 0, -1) + v.sh(1, 0, 0) + v.sh(0, 1, 0)
                + v.sh(0, 0, 1)) / 6.0 for n, v in views.items()}


def _k27(views, info):
    src, acc = views["u"], 0.0
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dz in (-1, 0, 1):
                acc = acc + src.sh(dx, dy, dz) / (2.0 ** (abs(dx) + abs(dy) + abs(dz)))
    return {"u": acc / 8.0}


def _forced(views, info):
    src = views["u"]
    cx, cy, cz = info.coords()
    g = info.global_size
    val = (src.sh(1, 0, 0) + src.sh(-1, 0, 0) + src.sh(0, 1, 0) + src.sh(0, -1, 0)) / 4.0
    d2 = (cx - g.x // 2) ** 2 + (cy - g.y // 2) ** 2 + (cz - g.z // 2) ** 2
    return {"u": torch.where(d2 < 9, 1.0, val * info.level)}


def _vc(views, info):
    u, c = views["u"], views["c"]
    lap = (u.sh(-1, 0, 0) + u.sh(1, 0, 0) + u.sh(0, -1, 0) + u.sh(0, 1, 0) + u.sh(0, 0, -1)
           + u.sh(0, 0, 1) - 6.0 * u.center())
    return {"u": u.center() + c.center() * lap}


def _r2(views, info):
    s = views["u"]
    return {"u": (s.sh(-2, 0, 0) + s.sh(2, 0, 1) + s.sh(0, -2, 1) + s.sh(1, 2, 0) + s.sh(0, 0, -2)
                  + s.sh(-1, 0, 2)) / 6.0}


STREAM_KERNELS = {"mean6": (_mean6, ["a", "b"]), "k27": (_k27, ["u"]), "forced": (_forced, ["u"]),
                  "vc": (_vc, ["u", "c"])}


def _wavefront_gs(s, slabs):
    return (2 * (90 - 2 * s) + 3, 2 * (70 - 2 * s), 2 * ((127 if slabs else 130) - 2 * s))


@pytest.fixture(scope="module")
def stream_libs():
    """The card, with every stream library the tests below launch built up
    front, one nvcc each, all at once (a lazy build would run them one by
    one)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    from stencil_tpu_torch.kernels import build
    from stencil_tpu_torch.ops.stream_trace import StreamKernel

    want = []
    for kern, names in STREAM_KERNELS.values():
        want.append(("stream_wrap", st._source(StreamKernel(kern, names, 1, (18, 20, 70)), "stream_wrap",
                                                st._WRAP_LEVELS)))
        want.append(("stream_plane", st._source(StreamKernel(kern, names, 1, (30, 40, 140)),
                                                 "stream_plane", [1])))
        for m, s in ((1, 1), (2, 3), (3, 3)):
            for slabs in (False, True):
                sk = StreamKernel(kern, names, 1, _wavefront_gs(s, slabs))
                want.append(("stream_wavefront", st._source(sk, *st._wavefront_variant(m))))
    want.append(("stream_plane", st._source(StreamKernel(_r2, ["u"], 2, (30, 40, 140)), "stream_plane", [1])))
    build.build_generated(dict.fromkeys(want))
    return torch.device("cuda")


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("name", sorted(STREAM_KERNELS))
def test_stream_wrap_kernel_equals_plain(stream_libs, name, k):
    dev = stream_libs
    kern, names = STREAM_KERNELS[name]
    gs = (18, 20, 70)
    blocks = [_rand(gs, 11 + q, dev) for q in range(len(names))]
    org = torch.zeros(3, dtype=torch.int32, device=dev)
    before = st.stream_wrap_pass.launches
    got = st.stream_wrap_pass(kern, names, blocks, k, org, gs)
    torch.cuda.synchronize()
    assert st.stream_wrap_pass.launches == before + k  # one level per launch
    for g, w in zip(got, st.stream_wrap_pass_plain(kern, names, blocks, k, org, gs)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("name,r", [("mean6", 1), ("k27", 1), ("forced", 1), ("vc", 1), ("r2", 2)])
def test_stream_plane_kernel_equals_plain(stream_libs, name, r):
    dev = stream_libs
    kern, names = STREAM_KERNELS[name] if name in STREAM_KERNELS else (_r2, ["u"])
    lo, hi = Dim3(r, r + 1, r), Dim3(r + 1, r, r + 2)
    gs = (30, 40, 140)
    raws = [_rand((2, 17, 19, 70), 21 + q, dev) for q in range(len(names))]
    org = torch.tensor([[0, 0, 0], [13, 17, 60]], dtype=torch.int32, device=dev)
    before = st.stream_plane_pass.launches
    got = st.stream_plane_pass(kern, names, raws, lo, hi, r, org, gs)
    torch.cuda.synchronize()
    assert st.stream_plane_pass.launches == before + 1  # all blocks and fields in one launch
    for g, w in zip(got, st.stream_plane_pass_plain(kern, names, raws, lo, hi, r, org, gs)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("m,s", [(1, 1), (2, 3), (3, 3)])
@pytest.mark.parametrize("slabs", [False, True])
@pytest.mark.parametrize("name", sorted(STREAM_KERNELS))
def test_stream_wavefront_kernel_equals_plain(stream_libs, name, m, s, slabs):
    """Ragged blocks (several tiles and x chunks), dead columns past z_valid
    in the slab form; compared on the valid region."""
    dev = stream_libs
    kern, names = STREAM_KERNELS[name]
    Xr, Yr, Zr = 90, 70, 130
    zv = 127 if slabs else Zr
    gs = _wavefront_gs(s, slabs)
    raws = [_rand((2, Xr, Yr, Zr), 31 + q, dev) for q in range(len(names))]
    zs = [_rand((2, Xr, 2 * s, Yr), 41 + q, dev) for q in range(len(names))] if slabs else None
    org = torch.tensor([[5, 0, 7], [gs[0] - 3, Yr - 2 * s, 0]], dtype=torch.int32, device=dev)
    kw = dict(z_slabs=zs, z_valid=zv if slabs else None)
    before = st.stream_wavefront_pass.launches
    got, got_z = st.stream_wavefront_pass(kern, names, raws, m, s, org, gs, **kw)
    torch.cuda.synchronize()
    assert st.stream_wavefront_pass.launches == before + 1  # m levels in one launch
    want, want_z = st.stream_wavefront_pass_plain(kern, names, raws, m, s, org, gs, **kw)
    S = slice(s, -s)
    for g, w in zip(got, want):
        assert torch.equal(g[:, S, S, s:zv - s], w[:, S, S, s:zv - s])
    for g, w in zip(got_z or [], want_z or []):
        assert torch.equal(g[:, S, :, S], w[:, S, :, S])


def test_astaroth_routes_agree_on_card(dev):
    """wrap, plane and both wavefront forms on 1 and 8 subdomains against the
    torch engine, 2 quantities: bitwise."""
    runs = [AstarothSim(32, 32, 32, num_quantities=2)]
    for sub in (1, 8):
        for schedule in ("auto", "per-step", "wavefront"):
            runs.append(AstarothSim(32, 32, 32, num_quantities=2, subdomains=sub, kernel_impl="cuda",
                                    schedule=schedule))
    for m in runs:
        m.realize()
        m.step(7)
    for m in runs[1:]:
        for i in range(2):
            assert np.array_equal(m.field(i), runs[0].field(i))


def test_astaroth_uneven_routes_agree_on_card(dev):
    """31^3 over 2x2x2 (16 + 15 cells a side), auto (per-field plain
    wavefront) and per-step (plane), against one unpadded subdomain."""
    runs = [AstarothSim(31, 31, 31, num_quantities=2, kernel_impl="cuda")]
    for schedule in ("auto", "per-step"):
        runs.append(AstarothSim(31, 31, 31, num_quantities=2, kernel_impl="cuda", schedule=schedule))
        runs[-1].dd.set_partition(2, 2, 2)
    for m in runs:
        m.realize()
        m.step(7)
    assert runs[1]._step._stream_plan["route"] == "wavefront" and not runs[1]._step._stream_plan["z_slabs"]
    for m in runs[1:]:
        assert m.dd.padded()
        for i in range(2):
            assert np.array_equal(m.field(i), runs[0].field(i))
