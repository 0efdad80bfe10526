"""The port's ``AstarothSim`` against the JAX package's, 2 quantities at 16^3.

The port's ``cuda`` engine runs here through the stream kernels' plain
versions (CPU tensors).  Both packages start from the JAX package's initial
fields (``load_state``; the initial fields themselves are compared apart,
within ``INIT_ATOL``: both compute the sine in float64, with two libraries).
What each route is held to:

* port ``torch`` vs JAX ``jnp``, and port ``cuda`` (every schedule) vs JAX
  ``jnp``: bitwise.  All sum x-1, y-1, z-1, x+1, y+1, z+1 and multiply by
  float32(1/6);
* port ``cuda`` vs JAX ``pallas`` (interpret): bitwise on the plane route
  (``per-step``); on the wrap and wavefront routes the JAX route itself
  differs from its ``jnp`` route by an ulp (XLA on the CPU contracts a
  level's multiply into the next level's adds, the "last-ulp fusion
  effects" of its docstring, ``models/astaroth.py:20-28``), so there the
  test checks that and holds the port within ``tests/test_stream.py:26``'s
  tolerance.
"""

import jax
import numpy as np
import pytest
import torch

from stencil_tpu.models.astaroth import AstarothSim as JAstaroth
from stencil_tpu_torch.models.astaroth import AstarothSim

# several test workers share the host's cores; these small tensors need no
# intra-op threads
torch.set_num_threads(1)

TOL = dict(rtol=1e-6, atol=1e-6)
INIT_ATOL = 1e-6  # two float64 sines, one float32 rounding each
N = 16
STEPS = 5  # a macro of 3 and a remainder of 2 on the wavefront route


def _jax(subdomains, **kw):
    m = JAstaroth(N, N, N, num_quantities=2, devices=jax.devices()[:subdomains], **kw)
    m.realize()
    return m


def _port(subdomains, **kw):
    m = AstarothSim(N, N, N, num_quantities=2, subdomains=subdomains, device="cpu", **kw)
    m.realize()
    return m


def _fields(m):
    return [np.asarray(m.field(i)) for i in range(2)]


@pytest.mark.parametrize("subdomains", [1, 8])
def test_initial_fields_match_jax(subdomains):
    t, j = _port(subdomains), _jax(subdomains)
    for got, want in zip(_fields(t), _fields(j)):
        np.testing.assert_allclose(got, want, rtol=0, atol=INIT_ATOL)
        assert np.abs(got).max() <= 1.0


@pytest.mark.parametrize("subdomains", [1, 8])
@pytest.mark.parametrize("schedule", ["auto", "per-step", "wavefront"])
def test_cuda_routes_vs_jax(subdomains, schedule):
    routes = {(1, "auto"): "wrap", (8, "auto"): "wavefront", (1, "per-step"): "plane",
              (8, "per-step"): "plane", (1, "wavefront"): "wavefront", (8, "wavefront"): "wavefront"}
    jnp_ref = _jax(subdomains)
    pallas = _jax(subdomains, kernel_impl="pallas", interpret=True, schedule=schedule)
    t = _port(subdomains, kernel_impl="cuda", schedule=schedule)
    plan = t._step._stream_plan
    assert plan["route"] == pallas._step._stream_plan["route"] == routes[(subdomains, schedule)]
    assert t._wavefront_m == pallas._wavefront_m == (3 if plan["route"] == "wavefront" else 0)
    t.load_state([np.asarray(jnp_ref.dd.raw_to_host(h)) for h in jnp_ref.handles])
    for m in (jnp_ref, pallas, t):
        m.step(STEPS)
    exact = plan["route"] == "plane"
    for got, want, jp in zip(_fields(t), _fields(jnp_ref), _fields(pallas)):
        np.testing.assert_array_equal(got, want)
        if exact:
            np.testing.assert_array_equal(got, jp)
        else:
            assert not np.array_equal(want, jp)  # the JAX route's own fusion effect
            np.testing.assert_allclose(got, jp, **TOL)


@pytest.mark.parametrize("subdomains", [1, 8])
def test_torch_engine_vs_jnp(subdomains):
    j = _jax(subdomains)
    t = _port(subdomains)
    t.load_state([np.asarray(j.dd.raw_to_host(h)) for h in j.handles])
    j.step(STEPS)
    t.step(STEPS)
    for got, want in zip(_fields(t), _fields(j)):
        np.testing.assert_array_equal(got, want)


def test_every_route_agrees_bitwise():
    """Port only: torch engine, wrap, plane and both wavefront forms, one
    state, 7 steps: bitwise on the interior, and the raw blocks agree after
    the readback's re-exchange."""
    ref = _port(1)
    start = [r.copy() for r in ref.state()]
    runs = [ref, _port(1, kernel_impl="cuda"), _port(1, kernel_impl="cuda", schedule="per-step"),
            _port(1, kernel_impl="cuda", schedule="wavefront"), _port(8, kernel_impl="cuda"),
            _port(8, kernel_impl="cuda", schedule="per-step")]
    plain = _port(8, kernel_impl="cuda")
    plain._step = plain.dd.make_step(plain._kernel, engine="stream", x_radius=1, separable=True,
                                     stream_z_slabs=False)
    runs.append(plain)
    for m in runs[1:]:
        if m.dd.num_subdomains() == 1:
            m.load_state(start)
        else:
            m.dd.set_quantity(m.handles[0], ref.field(0))
            m.dd.set_quantity(m.handles[1], ref.field(1))
    for m in runs:
        m.step(7)
    want = _fields(ref)
    for m in runs[1:]:
        for got, w in zip(_fields(m), want):
            np.testing.assert_array_equal(got, w)
    # the stream routes leave the shell stale; the readback re-exchanges
    np.testing.assert_array_equal(runs[1].state()[0], runs[2].state()[0])


def test_eight_quantities_stream_per_field():
    """The bench configuration's 8 fields do not fit one Hopper block jointly
    at m = 3; the separable kernel streams them one at a time at full depth,
    bitwise equal to the torch engine."""
    t = AstarothSim(12, 12, 12, num_quantities=8, subdomains=8, kernel_impl="cuda",
                    schedule="wavefront", device="cpu")
    t.realize()
    ref = AstarothSim(12, 12, 12, num_quantities=8, subdomains=8, device="cpu")
    ref.realize()
    assert t._step._stream_plan["grouping"] == "per-field" and t._wavefront_m == 3
    t.step(4)
    ref.step(4)
    for i in range(8):
        np.testing.assert_array_equal(t.field(i), ref.field(i))


def test_state_round_trips_between_packages():
    j = _jax(8)
    j.step(2)
    t = _port(8, kernel_impl="cuda")
    t.load_state([np.asarray(j.dd.raw_to_host(h)) for h in j.handles])
    for got, want in zip(t.state(), [np.asarray(j.dd.raw_to_host(h)) for h in j.handles]):
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="quantities"):
        t.load_state(t.state()[:1])


def test_unported_options_name_the_roadmap():
    for kw in ({"check_divergence_every": 5}, {"storage_dtype": "bf16"}, {"compute_unit": "mxu"},
               {"mxu_input": "bf16"}):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            AstarothSim(8, 8, 8, device="cpu", **kw)
    # the exchange routes are ported: an unknown one is refused as in the JAX package
    with pytest.raises(ValueError, match="unknown exchange route"):
        AstarothSim(8, 8, 8, device="cpu", exchange_route="yzpack_all")
    m = AstarothSim(8, 8, 8, kernel_impl="cuda", device="cpu", stream_overlap="split")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        m.realize()
    with pytest.raises(ValueError, match="requires kernel_impl='cuda'"):
        AstarothSim(8, 8, 8, schedule="wavefront", device="cpu").realize()
    with pytest.raises(ValueError, match="schedule"):
        AstarothSim(8, 8, 8, schedule="sometimes", device="cpu")


def test_driver_prints_csv_row(capsys):
    from stencil_tpu_torch.bin import astaroth_sim

    rc = astaroth_sim.main(["--x", "12", "--y", "12", "--z", "12", "--iters", "2", "--quantities", "2",
                            "--device", "cpu", "--partition", "2,2,2", "--peer-copy", "--kernel"])
    assert rc == 0
    row = capsys.readouterr().out.strip().splitlines()[-1].split(",")
    assert row[:7] == ["astaroth", "peer/kernel", "1", "1", "12", "12", "12"]
    assert float(row[7]) > 0 and float(row[8]) >= float(row[7])
    rc = astaroth_sim.main(["--x", "10", "--y", "10", "--z", "10", "--iters", "1", "--device", "cpu",
                            "--schedule", "wavefront"])
    assert rc == 0
    assert capsys.readouterr().out.strip().split(",")[:7] == [
        "astaroth", "ppermute", "1", "1", "10", "10", "10"
    ]
