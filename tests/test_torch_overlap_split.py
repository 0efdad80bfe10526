"""The port's split overlap schedule (``overlap="split"``) and the torch
engine's interior/exterior overlap (``make_step(overlap=True)``), on the CPU.

* ``make_step(engine="stream", stream_overlap="split")`` against
  ``stream_overlap="off"`` in the port, interiors bitwise (the split
  output's shell is stale by contract, ``tests/test_overlap_split.py:84-104``):
  the plane route at read radius 1 and 2 and with a wide shell, the plain
  wavefront (two macros and a remainder), every ``EXCHANGE_ROUTES`` route,
  and uneven sizes (the high bands at per-block offsets);
* the port's split step against the JAX package's (interpret mode): bitwise
  on the plane route, ``TOL`` on the wavefront at depth >= 2 (the JAX
  interpret passes contract a level's multiply into the next level's adds;
  ROADMAP.md queue 3);
* every degradation of ``tests/test_overlap_split.py:210-251``, with its
  warning and the plan it resolves to, and the resolution against the JAX
  package's;
* the band windows are exactly ``3w`` wide (the port's choice over the TPU's
  tile granule; ROADMAP.md queue 3);
* ``make_step(engine="torch", overlap=True)`` against ``overlap=False`` and
  against the JAX package's ``jnp`` route: bitwise.

On the CPU the schedule runs serially (the interior pass, then the
exchange); the card runs the exchange on a second stream
(``tests/test_torch_cuda.py``).  ``TOL`` is rtol = atol = 1e-6.
"""

import warnings

import jax
import numpy as np
import pytest
import torch

from stencil_tpu.core.radius import Radius as JRadius
from stencil_tpu.domain import DistributedDomain as JDomain
from stencil_tpu_torch.core.radius import Radius
from stencil_tpu_torch.domain import DistributedDomain
from stencil_tpu_torch.ops import exchange as tex
from stencil_tpu_torch.ops import stream as st

torch.set_num_threads(1)

TOL = dict(rtol=1e-6, atol=1e-6)


def mean6(views, info):
    return {n: (s.sh(-1, 0, 0) + s.sh(0, -1, 0) + s.sh(0, 0, -1) + s.sh(1, 0, 0) + s.sh(0, 1, 0)
                + s.sh(0, 0, 1)) / 6.0 for n, s in views.items()}


def r2_kernel(views, info):
    """Reads at distance 2 on every axis."""
    s = views["q0"]
    return {"q0": (s.sh(-2, 0, 0) + s.sh(2, 0, 1) + s.sh(0, -2, 1) + s.sh(1, 2, 0) + s.sh(0, 0, -2)
                   + s.sh(-1, 0, 2)) / 6.0}


def forced(views, info):
    """Reads the global coordinates: the narrow passes' origin shift must
    reproduce them."""
    src = views["q0"]
    cx, cy, cz = info.coords()
    val = (src.sh(1, 0, 0) + src.sh(-1, 0, 0) + src.sh(0, 1, 0) + src.sh(0, -1, 0)) / 4.0
    g = info.global_size
    d2 = (cx - g.x // 2) ** 2 + (cy - g.y // 3) ** 2 + (cz - g.z // 4) ** 2
    return {"q0": torch.where(d2 < 9, 1.0, val)}


def _rand(shape, seed):
    return np.random.default_rng(seed).random(shape).astype(np.float32)


def _tmk(size=(16, 16, 16), radius=1, mult=1, route=None, nf=2, subdomains=8, seed=3):
    dd = DistributedDomain(*size, device="cpu")
    dd.set_radius(Radius.constant(radius))
    dd.set_subdomains(subdomains)
    if mult > 1:
        dd.set_halo_multiplier(mult)
    if route is not None:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # a packed route falls back on uneven axes
            dd.set_exchange_route(route)
    hs = [dd.add_data(f"q{i}") for i in range(nf)]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        dd.realize()
    for i, h in enumerate(hs):
        dd.set_quantity(h, _rand(size, seed + i))
    return dd, hs


def _jmk(size=(16, 16, 16), radius=1, mult=1, route=None, nf=2, subdomains=8, seed=3):
    dd = JDomain(*size)
    dd.set_radius(JRadius.constant(radius))
    dd.set_devices(jax.devices()[:subdomains])
    if route is not None:
        dd.set_exchange_route(route)
    if mult > 1:
        dd.set_halo_multiplier(mult)
    hs = [dd.add_data(f"q{i}") for i in range(nf)]
    dd.realize()
    for i, h in enumerate(hs):
        dd.set_quantity(h, _rand(size, seed + i))
    return dd, hs


#: (stream_path, kernel, names, radius, halo multiplier, steps, expected route)
CASES = {
    "plane_r1": ("plane", mean6, ["q0", "q1"], 1, 1, 3, "plane"),
    "plane_r2": ("plane", r2_kernel, ["q0"], 2, 1, 3, "plane"),
    "plane_wide": ("plane", forced, ["q0"], 1, 2, 3, "plane"),
    "wavefront": ("auto", mean6, ["q0", "q1"], 1, 3, 7, "wavefront"),
}


def _run(case, overlap, route, size=(16, 16, 16), **kw):
    path, kern, names, radius, mult, steps, _ = CASES[case]
    dd, hs = _tmk(size=size, radius=radius, mult=mult, route=route, nf=len(names))
    step = dd.make_step(kern, engine="stream", stream_path=path, stream_overlap=overlap, **kw)
    dd.run_step(step, steps)
    return dd, hs, step


@pytest.mark.parametrize("route", tex.EXCHANGE_ROUTES)
@pytest.mark.parametrize("case", sorted(CASES))
def test_split_equals_off(case, route):
    da, ha, sa = _run(case, "off", route, stream_z_slabs=False)
    db, hb, sb = _run(case, "split", route)
    plan = sb._stream_plan
    assert plan["overlap"] == "split" and plan["route"] == CASES[case][6] and not plan["z_slabs"]
    assert plan["m"] == sa._stream_plan["m"] and sa._stream_plan["overlap"] == "off"
    for a, b in zip(ha, hb):
        np.testing.assert_array_equal(da.quantity_to_host(a), db.quantity_to_host(b))


@pytest.mark.parametrize("size", [(15, 14, 13), (17, 16, 15)])
@pytest.mark.parametrize("case", sorted(CASES))
def test_split_equals_off_on_uneven_sizes(case, size):
    da, ha, _ = _run(case, "off", "direct", size=size)
    db, hb, sb = _run(case, "split", "direct", size=size)
    assert db.padded() and sb._stream_plan["overlap"] == "split"
    for a, b in zip(ha, hb):
        np.testing.assert_array_equal(da.quantity_to_host(a), db.quantity_to_host(b))


def test_split_bands_carry_the_fix():
    """Without the exterior passes the split step differs from off: the
    interior pass read the stale shell (a guard on the test above)."""
    da, ha, _ = _run("plane_r1", "off", None)
    db, hb, sb = _run("plane_r1", "split", None)
    dc, hc = _tmk()
    steps = CASES["plane_r1"][5]
    # the interior pass alone, over the pre-exchange stacks
    stacks = [dc.get_curr(h) for h in hc]
    shell = dc.shell_radius()
    for _ in range(steps):
        blocks = [s.view(8, *s.shape[3:]) for s in stacks]
        outs = st.stream_plane_pass(mean6, ["q0", "q1"], blocks, shell.lo(), shell.hi(), 1, dc.origins(), dc.size())
        tex.halo_exchange_multi(stacks, shell)
        stacks = [o.view(s.shape) for o, s in zip(outs, stacks)]
    for name, s in zip(["q0", "q1"], stacks):
        dc._curr[name] = s
    assert not all(np.array_equal(da.quantity_to_host(a), dc.quantity_to_host(c)) for a, c in zip(ha, hc))
    assert all(np.array_equal(da.quantity_to_host(a), db.quantity_to_host(b)) for a, b in zip(ha, hb))


@pytest.mark.parametrize("case", ["plane_r1", "plane_wide", "wavefront"])
def test_split_band_windows_are_3w(monkeypatch, case):
    """Each narrow pass runs over a sub-block exactly 3w wide along its
    axis (w = x_radius on the plane route, the macro's depth on the
    wavefront, so 3 then 1 for 7 steps at m = 3) and the full raw extent
    along the others."""
    seen = []
    fn = "stream_plane_pass" if CASES[case][6] == "plane" else "stream_wavefront_pass"
    real = getattr(st, fn)

    def spy(kernel, names, raws, *a, **k):
        seen.append(tuple(raws[0].shape))
        return real(kernel, names, raws, *a, **k)

    monkeypatch.setattr(st, fn, spy)
    dd, hs, step = _run(case, "split", None)
    raw = dd.local_spec().raw_size().tuple()
    narrow = [sh for sh in seen if sh[1:] != raw]
    ws = {1} if CASES[case][6] == "plane" else {3, 1}
    assert narrow and len(narrow) == 6 * (len(seen) - len(narrow))
    for sh in narrow:
        axes = [ax for ax in range(3) if sh[1 + ax] != raw[ax]]
        assert len(axes) == 1 and sh[1 + axes[0]] in {3 * w for w in ws}


@pytest.mark.parametrize("case", ["plane_r1", "wavefront"])
def test_split_vs_jax(case):
    path, kern, names, radius, mult, steps, _ = CASES[case]
    td, th, step = _run(case, "split", None)
    jd, jh = _jmk(radius=radius, mult=mult, nf=len(names))
    jstep = jd.make_step(kern, engine="stream", stream_path=path, interpret=True, stream_overlap="split")
    assert jstep._stream_plan["overlap"] == "split" and jstep._stream_plan["m"] == step._stream_plan["m"]
    assert not jstep._stream_plan["z_slabs"]
    jd.run_step(jstep, steps)
    for a, b in zip(th, jh):
        got, want = td.quantity_to_host(a), np.asarray(jd.quantity_to_host(b))
        if case == "plane_r1":
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, **TOL)


# --- resolution and degradation (tests/test_overlap_split.py:210-251) --------------


def test_overlap_unknown_request_rejected():
    dd, _ = _tmk(mult=2)
    with pytest.raises(ValueError, match="unknown stream overlap"):
        dd.make_step(mean6, engine="stream", stream_overlap="bogus")


def test_split_degrades_on_wrap_route():
    dd, _ = _tmk(subdomains=1)
    with pytest.warns(RuntimeWarning, match="'wrap' route has no exchange to hide"):
        step = dd.make_step(mean6, engine="stream", stream_overlap="split")
    assert step._stream_plan["route"] == "wrap" and step._stream_plan["overlap"] == "off"


def test_split_structural_guard_on_zslab_plan():
    plan = {"route": "wavefront", "m": 2, "z_slabs": True, "grouping": "joint",
            "overlap": "split", "overlap_forced": True}
    with pytest.warns(RuntimeWarning, match="z-slab wavefront interleaves"):
        val, source = st._resolve_stream_overlap(plan)
    assert (val, source) == ("off", "explicit/degraded")
    assert st._resolve_stream_overlap({"route": "plane"}) == ("off", "static")


def test_split_replans_zslab_to_plain_form():
    dd, _ = _tmk(mult=2)
    static = st.plan_stream(dd, 1)
    assert static["route"] == "wavefront" and static["z_slabs"]
    step = dd.make_step(mean6, engine="stream", stream_overlap="split")
    plan = step._stream_plan
    assert plan["route"] == "wavefront" and not plan["z_slabs"] and plan["overlap"] == "split"
    assert plan["m"] == static["m"]
    assert st.plain_wavefront_plan(dict(static, route="plane")) is None
    assert st.plain_wavefront_plan(dict(static, z_slabs=False)) is None
    # an explicit z_slabs=True keeps the slab form, and split degrades there
    with pytest.warns(RuntimeWarning, match="z-slab wavefront interleaves"):
        step = dd.make_step(mean6, engine="stream", stream_overlap="split", stream_z_slabs=True)
    assert step._stream_plan["z_slabs"] and step._stream_plan["overlap"] == "off"


@pytest.mark.parametrize("subdomains,mult,path", [(8, 2, "auto"), (8, 1, "plane"), (1, 1, "auto")])
def test_overlap_resolution_matches_jax(subdomains, mult, path):
    for overlap in ("auto", "off", "split"):
        td, _ = _tmk(mult=mult, subdomains=subdomains)
        jd, _ = _jmk(mult=mult, subdomains=subdomains)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            got = td.make_step(mean6, engine="stream", stream_path=path, stream_overlap=overlap)._stream_plan
        want = jd.make_step(mean6, engine="stream", stream_path=path, interpret=True,
                            stream_overlap=overlap)._stream_plan
        assert (got["overlap"], got["route"], got["z_slabs"]) == (want["overlap"], want["route"], want["z_slabs"])
        degraded = overlap == "split" and subdomains == 1
        assert any(issubclass(w.category, RuntimeWarning) for w in caught) == degraded


# --- the torch engine: make_step(overlap=True) -----------------------------------------


@pytest.mark.parametrize("size,mult,subdomains", [((16, 16, 16), 1, 8), ((15, 14, 13), 1, 8), ((16, 16, 16), 2, 8),
                                                  ((12, 12, 12), 1, 1)])
@pytest.mark.parametrize("route", ["direct", "yzpack_pallas"])
def test_torch_engine_overlap_equals_off_and_jax(size, mult, subdomains, route):
    """The interior from the pre-exchange stacks, then the exterior slabs:
    bitwise equal to overlap=False and to the JAX package's jnp route (a
    pass-through field that is a shifted view of the stacks included)."""

    def passthru(views, info):
        u = views["q0"]
        return {"q0": u.sh(1, 0, 0), "q1": (views["q1"].center() + u.sh(0, -1, 0)) * 0.5}

    for kern in (mean6, passthru):
        outs = []
        for overlap in (False, True):
            dd, hs = _tmk(size=size, mult=mult, subdomains=subdomains, route=route)
            dd.run_step(dd.make_step(kern, overlap=overlap), 3)
            outs.append([dd.quantity_to_host(h) for h in hs])
        jd, jh = _jmk(size=size, mult=mult, subdomains=subdomains)
        jd.run_step(jd.make_step(kern, overlap=True), 3)
        for a, b, h in zip(*outs, jh):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(b, np.asarray(jd.quantity_to_host(h)))


def test_overlapped_runs_the_interior_first_on_the_cpu():
    order = []
    out = tex.overlapped(None, lambda: order.append("interior") or 7, lambda: order.append("exchange"))
    assert out == 7 and order == ["interior", "exchange"]
    assert tex.side_stream(torch.device("cpu")) is None
