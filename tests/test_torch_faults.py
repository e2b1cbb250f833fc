"""Parity of the port's fault-injection slice (``repro_torch.faults``, the
``packet_erasure`` family, ``thompson``) with the JAX package, on the CPU.

:class:`JaxFaultDraws` extends the engine's replay (``JaxDraws``) with the
uniforms ``repro.faults`` draws from its fault stream — injector ``i`` of a
channel draws from ``fold_in(fault_key(key), i)``, split in two where it
takes two parts — and with ``jax.random.beta``'s variates on the policy
stream.  On those draws the port's traces, masks, counts, exact decodes and
sweep outcomes equal ``repro``'s bit for bit; float decodes are held to a
stated tolerance.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import faults as jfaults
from repro import sweeps as jsweeps
from repro.core import coded_ops as jco
from repro.core import lagrange as jlag
from repro.core import lea as jlea
from repro.core import markov as jmarkov
from repro.core import throughput as jtp
from repro.core.throughput import _POLICY_KEY_TAG
from repro.faults.channels import _FAULT_KEY_TAG
from repro.policies import registry as jregistry
from repro.policies.api import PolicyContext as JPolicyContext
from repro_torch import faults, sweeps
from repro_torch.core import coded_ops, lagrange, markov, throughput
from repro_torch.core.lea import LoadParams, PoolLoad
from repro_torch.policies import registry
from repro_torch.policies.api import PolicyContext
from repro_torch.random import (FaultDraws, RecordedDraws, ReplayedDraws, as_draws,
                                torch_draws)
from test_torch_engine import JaxDraws, _split_rows, _uniforms

CPU = "cpu"
MU_G, MU_B, DEADLINE = 10.0, 3.0, 1.0
P = (1 << 31) - 1

_fold = jax.jit(jax.vmap(jax.random.fold_in, in_axes=(0, None)))
_split2 = jax.jit(jax.vmap(jax.random.split))
_beta = jax.jit(jax.vmap(jax.random.beta))


@functools.lru_cache(maxsize=None)
def _uniform_shape(shape):
    return jax.jit(jax.vmap(lambda k: jax.random.uniform(k, shape)))


def _as_keys(keys):
    return jnp.asarray(np.array(keys), jnp.uint32).reshape(-1, 2)


def jax_fault_uniforms(keys, parts, position, part, shape):
    """The uniforms ``repro``'s injector at ``position`` of a channel draws
    for part ``part``, (rows, *shape), from the (rows, 2) channel keys:
    ``fold_in(key, position)``, split in two where the injector takes two
    ``parts``; a ``chain`` part is ``sample_trajectory_from``'s per-step
    draws."""
    k = _fold(_as_keys(keys), position)
    if len(parts) == 2:
        k = _split2(k)[:, parts.index(part)]
    if part == "chain":
        return _uniforms(shape[1], 2)(_split_rows(shape[0])(k))
    return _uniform_shape(tuple(shape))(k)


class JaxFaultDraws(JaxDraws):
    """``JaxDraws`` that also replays ``repro``'s fault and Beta draws.

    ``keys`` are the per-row simulation keys; the fault root is
    ``fault_key(key)`` unless ``fault_root`` gives the keys handed to
    ``apply_channel`` itself.  ``channel`` is the port's channel (each
    injector names the parts it draws).  Beta calls alternate between the
    two halves of ``split(fold_in(fold_in(key, policy tag), policy_index))``
    (or of ``policy_root``, the policy's own key).
    """

    def __init__(self, keys, channel=(), *, fault_root=None, policy_index=0,
                 policy_root=None, **kw):
        super().__init__(keys, **kw)
        keys = _as_keys(keys)
        self.fault_keys = (_fold(keys, _FAULT_KEY_TAG) if fault_root is None
                           else _as_keys(fault_root))
        self.parts = [type(inj).parts for inj in channel]
        root = (_fold(_fold(keys, _POLICY_KEY_TAG), policy_index)
                if policy_root is None else _as_keys(policy_root))
        halves = _split2(root)
        self._beta_keys = (halves[:, 0], halves[:, 1])
        self.beta_calls = 0

    def fault(self, rows, position, part, shape):
        u = jax_fault_uniforms(self.fault_keys, self.parts[position], position, part, shape)
        assert u.shape == (rows,) + tuple(shape)
        return self._t(u)

    def beta(self, a, b):
        k = self._beta_keys[self.beta_calls % 2]
        self.beta_calls += 1
        return self._t(_beta(k, jnp.asarray(a.numpy()), jnp.asarray(b.numpy())))


ALL_INJECTORS = [
    ("crash_restart", {"p_crash": 0.3, "p_restart": 0.5}),
    ("preempt", {"p_preempt": 0.5, "min_frac": 0.2}),
    ("packet_bernoulli", {"p_drop": 0.3}),
    ("gilbert_elliott", {"p_gb": 0.3, "p_bg": 0.4, "drop_bad": 0.8}),
    ("burst", {"p_event": 0.4, "frac": 0.5}),
]


def _jax_trace(key, spec, rounds, n, r, packets):
    return jfaults.apply_channel(key, jfaults.make_channel(spec),
                                 jfaults.base_trace(rounds, n, r, packets, DEADLINE))


def _port_trace(key, spec, rounds, n, r, packets):
    channel = faults.make_channel(spec)
    draws = JaxFaultDraws(np.array(key)[None], channel, fault_root=np.array(key)[None])
    return faults.apply_channel(
        draws, channel, faults.base_trace(1, rounds, n, r, packets, DEADLINE, device=CPU))


# ---------------------------------------------------------------------------
# markov.sample_trajectory_from and the injectors
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rounds", [1, 2, 65])
def test_sample_trajectory_from_matches_jax_exactly(rounds):
    rng = np.random.default_rng(rounds)
    n = 9
    stay1 = rng.uniform(0.3, 0.95, n).astype(np.float32)
    stay0 = rng.uniform(0.3, 0.95, n).astype(np.float32)
    init = rng.integers(0, 2, n).astype(np.int32)
    key = jax.random.PRNGKey(rounds)
    want = np.array(jmarkov.sample_trajectory_from(
        key, jnp.asarray(stay1), jnp.asarray(stay0), rounds, jnp.asarray(init)))
    u = (None if rounds == 1 else
         torch.from_numpy(np.array(_uniforms(n, 2)(_split_rows(rounds - 1)(key[None])))))
    got = markov.sample_trajectory_from(u, torch.from_numpy(stay1), torch.from_numpy(stay0),
                                        torch.from_numpy(init)[None])
    np.testing.assert_array_equal(got[0].numpy(), want)


@pytest.mark.parametrize("name,params", ALL_INJECTORS)
@pytest.mark.parametrize("seed", [0, 1])
def test_each_injector_matches_jax_bitwise(name, params, seed):
    key = jax.random.PRNGKey(seed)
    want = _jax_trace(key, [(name, params)], 16, 5, 3, 4)
    got = _port_trace(key, [(name, params)], 16, 5, 3, 4)
    np.testing.assert_array_equal(got.t_cut[0].numpy(), np.array(want.t_cut))
    np.testing.assert_array_equal(got.keep[0].numpy(), np.array(want.keep))
    # monotone: the cutoff only falls and packets are only lost
    assert bool((got.t_cut <= DEADLINE).all())


@pytest.mark.parametrize("pair", [(1, 2), (0, 3), (4, 1), (3, 2)])
def test_two_injector_channels_match_jax_bitwise(pair):
    spec = [ALL_INJECTORS[i] for i in pair]
    key = jax.random.PRNGKey(sum(pair))
    want = _jax_trace(key, spec, 20, 6, 3, 4)
    got = _port_trace(key, spec, 20, 6, 3, 4)
    np.testing.assert_array_equal(got.t_cut[0].numpy(), np.array(want.t_cut))
    np.testing.assert_array_equal(got.keep[0].numpy(), np.array(want.keep))
    # a channel's prefix shares that prefix's faults exactly
    head = _port_trace(key, spec[:1], 20, 6, 3, 4)
    if spec[1][0] in ("packet_bernoulli", "gilbert_elliott", "burst"):
        assert torch.equal(head.t_cut, got.t_cut)


def test_registry_matches_jax_and_rejects_unknown_names():
    assert faults.injector_names() == jfaults.injector_names()
    with pytest.raises(KeyError, match="packet_bernoulli"):
        faults.make_injector("no_such_fault")
    channel = faults.make_channel(ALL_INJECTORS)
    assert [inj.injector_name for inj in channel] == [n for n, _ in ALL_INJECTORS]
    tr = faults.base_trace(2, 4, 3, 2, 4, torch.tensor([1.0, 2.5]), device=CPU)
    assert tr.rows == 2 and tr.rounds == 4
    assert tr.t_cut[1].eq(2.5).all() and bool(tr.keep.all())


def test_per_row_parameters_ride_their_rows():
    """A (B,) parameter gives row b exactly the faults of a one-row channel
    with that row's value, on the same uniforms."""
    p_pre = torch.tensor([0.0, 0.3, 0.9])
    p_drop = torch.tensor([0.5, 0.0, 0.2])
    spec = lambda a, b: [("preempt", {"p_preempt": a}), ("packet_bernoulli", {"p_drop": b})]
    draws = RecordedDraws(torch_draws(5, CPU))
    batched = faults.apply_channel(draws, faults.make_channel(spec(p_pre, p_drop)),
                                   faults.base_trace(3, 8, 4, 2, 3, DEADLINE, device=CPU))
    for row in range(3):
        one = faults.apply_channel(
            ReplayedDraws(draws.calls, row),
            faults.make_channel(spec(float(p_pre[row]), float(p_drop[row]))),
            faults.base_trace(1, 8, 4, 2, 3, DEADLINE, device=CPU))
        assert torch.equal(one.t_cut[0], batched.t_cut[row])
        assert torch.equal(one.keep[0], batched.keep[row])
    assert torch.equal(batched.t_cut[0], torch.full((8, 4), DEADLINE))
    assert not batched.keep[1].logical_not().any()


# ---------------------------------------------------------------------------
# packet masks, counts, layer 1
# ---------------------------------------------------------------------------

def _states_loads(seed, m, n, r):
    k0, k1 = jax.random.split(jax.random.PRNGKey(seed))
    states = jax.random.bernoulli(k0, 0.6, (m, n)).astype(jnp.int32)
    loads = jax.random.randint(k1, (m, n), 0, r + 1)
    return states, loads


@pytest.mark.parametrize("conserve", [True, False])
@pytest.mark.parametrize("faulted", [False, True])
@pytest.mark.parametrize("packets", [1, 4])
def test_packet_on_time_counts_and_layer1_match_jax(conserve, faulted, packets):
    n, r, m = 7, 4, 10
    states, loads = _states_loads(packets + 2 * faulted, m, n, r)
    spec = [ALL_INJECTORS[1], ALL_INJECTORS[2]]
    key = jax.random.PRNGKey(11)
    jtrace = _jax_trace(key, spec, m, n, r, packets) if faulted else None
    trace = _port_trace(key, spec, m, n, r, packets) if faulted else None
    want = np.array(jfaults.packet_on_time(states, loads, MU_G, MU_B, DEADLINE, r, packets,
                                           trace=jtrace, conserve=conserve))
    got = faults.packet_on_time(torch.from_numpy(np.array(states))[None],
                                torch.from_numpy(np.array(loads, np.int32))[None],
                                MU_G, MU_B, DEADLINE, r, packets, trace=trace,
                                conserve=conserve)[0]
    np.testing.assert_array_equal(got.numpy(), want)
    counts = faults.packet_counts(got)
    np.testing.assert_array_equal(counts.numpy(), np.array(jfaults.packet_counts(want)))
    for k1, p1 in ((3, 1), (5, packets)):
        np.testing.assert_array_equal(
            faults.layer1_recovery(counts, k1, p1).numpy(),
            np.array(jfaults.layer1_recovery(jnp.asarray(counts.numpy()), k1, p1)))


def test_packets1_aon_is_chunk_on_time_and_inside_conserve():
    n, r = 7, 4
    states, loads = (torch.from_numpy(np.array(x, np.int32)) for x in _states_loads(3, 6, n, r))
    chunk = coded_ops.chunk_on_time(states, loads, MU_G, MU_B, DEADLINE, r)
    aon = faults.packet_on_time(states, loads, MU_G, MU_B, DEADLINE, r, 1, conserve=False)
    con = faults.packet_on_time(states, loads, MU_G, MU_B, DEADLINE, r, 1, conserve=True)
    assert torch.equal(aon[..., 0], chunk)
    assert bool((~aon | con).all())


def test_preempted_work_counts_only_under_conserve():
    """One worker, load 4, cut at half its round: AON loses everything,
    conserve keeps the 8 packets finished before the cut."""
    states = torch.ones((1, 1, 1), dtype=torch.int32)
    loads = torch.full((1, 1, 1), 4, dtype=torch.int32)
    trace = faults.base_trace(1, 1, 1, 4, 4, DEADLINE, device=CPU)
    trace = trace._replace(t_cut=torch.full((1, 1, 1), 0.5))
    aon = faults.packet_on_time(states, loads, 4.0, 4.0, DEADLINE, 4, 4, trace=trace,
                                conserve=False)
    con = faults.packet_on_time(states, loads, 4.0, 4.0, DEADLINE, 4, 4, trace=trace)
    assert int(aon.sum()) == 0 and int(con.sum()) == 8


# ---------------------------------------------------------------------------
# both modes' counts in one call (kernels/packet_counts)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("faulted", [False, True])
@pytest.mark.parametrize("packets", [1, 3, 4])
def test_decode_counts_cpu_route_is_the_composition(faulted, packets):
    """A CPU tensor takes the plain version, which is the engine's old
    composition to the bit, and launches nothing."""
    from _packet_cases import composition, count_inputs

    from repro_torch.kernels import packet_counts as pc
    inputs = count_inputs(CPU, 2, 7, 4, packets, trace=faulted)
    before = pc.launch_counts()
    got = pc.decode_counts(*inputs[:5], 4, packets, inputs[5])
    want = composition(*inputs[:5], 4, packets, inputs[5])
    for g, w in zip(got, want, strict=True):
        assert g.dtype == torch.int32 and g.shape == (2, 4, 37, packets)
        assert torch.equal(g, w)
    assert pc.launch_counts() == before


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_aon_counts_are_at_most_conserve_counts(seed):
    """AON is inside conserve packet by packet, so its counts are at most
    conserve's, element by element; preempted work makes conserve larger
    somewhere."""
    from _packet_cases import count_inputs

    from repro_torch.kernels.packet_counts import decode_counts
    inputs = count_inputs(CPU, 3, 15, 10, 4, seed=seed)
    aon, con = decode_counts(*inputs[:5], 10, 4, inputs[5])
    assert bool((aon <= con).all()) and bool((con > aon).any())
    assert int(con[:, 1].max()) == 0          # row 1 keeps no packet


def _refused(case):
    from _packet_cases import count_inputs

    states, loads, mu_g, mu_b, deadline, (t_cut, keep) = count_inputs(CPU, 2, 5, 3, 4)
    if case == "keep_not_contiguous":
        keep = keep.transpose(-1, -2).contiguous().transpose(-1, -2)
    elif case == "loads_not_contiguous":
        loads = loads.transpose(0, 1).contiguous().transpose(0, 1)
    elif case == "states_int64":
        states = states.long()
    elif case == "loads_float32":
        loads = loads.float()
    elif case == "t_cut_float64":
        t_cut = t_cut.double()
    elif case == "keep_uint8":
        keep = keep.to(torch.uint8)
    elif case == "deadline_per_round":
        deadline = deadline[:, None].expand(4, 37).contiguous()
    elif case == "t_cut_without_keep":
        keep = None
    return (states, loads, mu_g, mu_b, deadline, 3, 4, t_cut, keep)


REFUSALS = {"keep_not_contiguous": "keep must be contiguous",
            "loads_not_contiguous": "loads must be contiguous",
            "states_int64": "int32", "loads_float32": "int32", "t_cut_float64": "float32",
            "keep_uint8": "bool", "deadline_per_round": r"\(4,\)",
            "t_cut_without_keep": "together", "cpu_tensors": "CUDA kernel"}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_packet_counts_wrapper_refuses_what_the_kernel_does_not_take(case):
    """The wrapper checks the layout before the device, so a CPU call shows
    every refusal; well-formed CPU tensors are refused as off the card."""
    from repro_torch.kernels.packet_counts import launch_counts, packet_counts_cuda
    before = launch_counts()
    with pytest.raises(ValueError, match=REFUSALS[case]):
        packet_counts_cuda(*_refused(case))
    assert launch_counts() == before


@pytest.mark.parametrize("n,rp,address,width", [
    (15, 40, 0, 16),       # fault_grid: two rounds of 600 bytes a warp
    (15, 40, 4104, 8), (15, 40, 4097, 1), (1, 3, 0, 16), (5, 9, 0, 4), (7, 2, 0, 8),
    (3, 1, 2, 2), (64, 40, 0, 16), (33, 9, 0, 1)])
def test_keep_load_width_divides_every_warps_offset_and_the_address(n, rp, address, width):
    from repro_torch.kernels.packet_counts import vector_width
    assert vector_width(n, rp, address) == width


# ---------------------------------------------------------------------------
# per-packet decodes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,packets,d", [(0, 4, 1), (1, 2, 3), (3, 1, 2)])
def test_exact_packet_decode_matches_jax_and_the_numpy_oracle(seed, packets, d):
    rng = np.random.default_rng(seed)
    spec_args = (6, 2, 4, 2)
    spec, jspec = lagrange.CodeSpec(*spec_args), jlag.CodeSpec(*spec_args)
    rows, cols = 8, 5
    x = rng.integers(0, P, size=(spec.k, rows, cols), dtype=np.int64)
    w = rng.integers(0, P, size=(cols, d) if d > 1 else (cols,), dtype=np.int64)
    pm = rng.random((spec.nr, packets)) < 0.7
    coded = coded_ops.encode_dataset_modp(spec, x, device=CPU)
    out, ok = faults.coded_matmul_exact_packets(coded, torch.from_numpy(w), torch.from_numpy(pm))
    jout, jok = jfaults.coded_matmul_exact_packets(
        jco.encode_dataset_modp(jspec, x), w, jnp.asarray(pm))
    np.testing.assert_array_equal(ok.numpy(), np.array(jok))
    np.testing.assert_array_equal(out.numpy(), np.array(jout))
    assert ok.any()
    want = lagrange.matmul_modp(x.reshape(-1, cols), w.reshape(cols, -1)).reshape(
        (spec.k, rows) + ((d,) if d > 1 else ()))
    rp = rows // packets
    for q in np.nonzero(ok.numpy())[0]:
        np.testing.assert_array_equal(out[:, q * rp:(q + 1) * rp].numpy().astype(np.int64),
                                      want[:, q * rp:(q + 1) * rp])


def test_exact_packets_at_one_packet_are_coded_matmul_exact():
    rng = np.random.default_rng(9)
    spec = lagrange.CodeSpec(6, 2, 4, 1)
    coded = coded_ops.encode_dataset_modp(
        spec, rng.integers(0, 997, size=(4, 8, 3)), device=CPU)
    w = torch.from_numpy(rng.integers(0, 997, size=(3,)))
    for _ in range(3):
        on = torch.from_numpy(rng.random(spec.nr) < 0.75)
        ref, ok_ref = coded_ops.coded_matmul_exact(coded, w, on)
        out, ok = faults.coded_matmul_exact_packets(coded, w, on[:, None])
        assert bool(ok[0]) == bool(ok_ref)
        assert torch.equal(out, ref)


@pytest.mark.parametrize("deg_f", [1, 2])
def test_float_packet_decode_matches_jax(deg_f):
    spec_args = (4, 3, 3, deg_f)
    spec, jspec = lagrange.CodeSpec(*spec_args), jlag.CodeSpec(*spec_args)
    rng = np.random.default_rng(deg_f)
    x = rng.normal(size=(spec.k, 8, 5)).astype(np.float32)
    w = rng.normal(size=(5,)).astype(np.float32)
    pm = rng.random((spec.nr, 4)) < 0.8
    out, ok = faults.coded_matmul_packets(
        coded_ops.encode_dataset(spec, torch.from_numpy(x)), torch.from_numpy(w),
        torch.from_numpy(pm))
    jout, jok = jfaults.coded_matmul_packets(
        jco.encode_dataset(jspec, jnp.asarray(x)), jnp.asarray(w), jnp.asarray(pm))
    np.testing.assert_array_equal(ok.numpy(), np.array(jok))
    assert ok.any()
    want = np.einsum("krc,c->kr", x, w)
    for q in np.nonzero(ok.numpy())[0]:
        block = slice(2 * q, 2 * q + 2)
        np.testing.assert_allclose(out[:, block].numpy(), np.array(jout)[:, block],
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(out[:, block].numpy(), want[:, block], rtol=1e-3, atol=1e-3)


def test_float_packet_blocks_against_the_reference_outputs():
    """The inputs of the reference's per-packet test: every decodable block
    within 1e-5 (rtol and atol) of ``repro``'s own per-packet output and of
    the port's single-mask decode of the same rows.  Row blocks may round
    differently from a whole decode, so no bit equality is asked."""
    rng = np.random.default_rng(0)
    spec, jspec = lagrange.CodeSpec(6, 2, 4, 1), jlag.CodeSpec(6, 2, 4, 1)
    x = rng.normal(size=(4, 8, 3)).astype(np.float32)
    w = rng.normal(size=(3,)).astype(np.float32)
    pm = rng.random((spec.nr, 4)) < 0.8
    coded = coded_ops.encode_dataset(spec, torch.from_numpy(x))
    out, ok = faults.coded_matmul_packets(coded, torch.from_numpy(w), torch.from_numpy(pm))
    jout, jok = jfaults.coded_matmul_packets(
        jco.encode_dataset(jspec, jnp.asarray(x)), jnp.asarray(w), jnp.asarray(pm))
    np.testing.assert_array_equal(ok.numpy(), np.array(jok))
    for q in range(4):
        ref_q, ok_q = coded_ops.coded_matmul_device(coded, torch.from_numpy(w),
                                                     torch.from_numpy(pm[:, q]))
        assert bool(ok[q]) == bool(ok_q)
        if bool(ok_q):
            block = slice(2 * q, 2 * q + 2)
            np.testing.assert_allclose(out[:, block].numpy(), np.array(jout)[:, block],
                                       rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(out[:, block].numpy(), ref_q[:, block].numpy(),
                                       rtol=1e-5, atol=1e-5)


def _route_bound(spec, x, w):
    """The float32 forward-error bound of the per-packet float route (as
    ``chip_smoke.py`` phase 11d): each decoded element within
    gamma_n (|D| @ A[received]) of the exact X_j @ w, A = |G| @ (|X| @ |w|),
    gamma_n = n u / (1 - n u), u = 2^-24, n = cols + 5 (k + K*)."""
    n = x.shape[-1] + 5 * (spec.k + spec.recovery_threshold)
    u = 2.0 ** -24
    g = lagrange.generator_matrix(spec, torch.float64, device=CPU).numpy()
    return np.abs(g) @ np.einsum("krc,c->kr", np.abs(x).astype(np.float64),
                                 np.abs(w).astype(np.float64)), n * u / (1 - n * u)


def test_float_packet_decode_on_mixed_node_sets_meets_the_route_bound_as_jax_does():
    """At ``CodeSpec(15, 10, 5, 2)``, on masks where preempted workers keep a
    prefix of their chunks and packets drop (received sets that mix
    workers' nodes), every decodable block of the port's and of ``repro``'s
    per-packet decode lies within the float32 bound of the route of the
    exact X_j @ w, and the two differ by at most twice that bound."""
    spec, jspec = lagrange.CodeSpec(15, 10, 5, 2), jlag.CodeSpec(15, 10, 5, 2)
    n, r, packets, kstar = 15, 10, 4, spec.recovery_threshold
    rng = np.random.default_rng(18)
    x = rng.normal(size=(spec.k, 8, 32)).astype(np.float32)
    w = rng.normal(size=(32,)).astype(np.float32)
    want = np.einsum("krc,c->kr", x.astype(np.float64), w.astype(np.float64))
    mags, gamma = _route_bound(spec, x, w)
    coded = coded_ops.encode_dataset(spec, torch.from_numpy(x))
    jcoded = jco.encode_dataset(jspec, jnp.asarray(x))
    blocks, mixed = 0, 0
    for _ in range(12):
        prefix = np.where(rng.random(n) < 0.5, rng.integers(0, r + 1, n), r)
        kept = (np.arange(r)[None, :] < prefix[:, None]).reshape(n * r)
        pm = kept[:, None] & (rng.random((n * r, packets)) > 0.1)
        out, ok = faults.coded_matmul_packets(coded, torch.from_numpy(w), torch.from_numpy(pm))
        jout, jok = jfaults.coded_matmul_packets(jcoded, jnp.asarray(w), jnp.asarray(pm))
        np.testing.assert_array_equal(ok.numpy(), np.array(jok))
        for q in np.nonzero(ok.numpy())[0]:
            block = slice(2 * q, 2 * q + 2)
            received = coded_ops.received_indices(torch.from_numpy(pm[:, q]), kstar)
            workers = set((received.numpy() // r).tolist())
            mixed += len(workers) > 1 and any(prefix[i] < r for i in workers)
            d = lagrange.decode_matrix_jax(spec, received).double().abs().numpy()
            bound = gamma * (d @ mags[received.numpy()][:, block])
            got, ref = out[:, block].numpy(), np.array(jout)[:, block]
            assert (np.abs(got - want[:, block]) <= bound).all()
            assert (np.abs(ref - want[:, block]) <= bound).all()
            assert (np.abs(got.astype(np.float64) - ref) <= 2 * bound).all()
            blocks += 1
    assert blocks >= 24 and mixed >= 12


def test_rows_must_divide_into_packets():
    spec = lagrange.CodeSpec(6, 2, 4, 1)
    coded = coded_ops.encode_dataset(spec, torch.zeros((4, 8, 3)))
    with pytest.raises(ValueError, match="divide"):
        faults.coded_matmul_packets(coded, torch.zeros(3), torch.ones((spec.nr, 3), dtype=torch.bool))


# ---------------------------------------------------------------------------
# the fault engine and the packet_erasure family
# ---------------------------------------------------------------------------

def test_packet_erasure_family_matches_jax():
    got, want = sweeps.expand("packet_erasure"), jsweeps.expand("packet_erasure")
    assert [s.name for s in got] == [s.name for s in want]
    for s, js in zip(got, want):
        assert s.meta == js.meta and s.rounds == js.rounds
        assert (s.lp.n, s.lp.kstar, s.lp.ell_g, s.lp.ell_b) == (
            js.lp.n, js.lp.kstar, js.lp.ell_g, js.lp.ell_b)
        assert (s.p_gg, s.p_bb, s.mu_g, s.mu_b, s.deadline) == (
            js.p_gg, js.p_bb, js.mu_g, js.mu_b, js.deadline)
    meta = dict(got[0].meta)
    assert (got[0].lp.kstar, meta["k1star"], meta["packets"], meta["r"]) == (99, 49, 4, 10)
    assert sweeps.describe("packet_erasure") == jsweeps.describe("packet_erasure")


def _grid(rounds):
    """The packet_erasure grid as both packages' sweep_faults arguments."""
    scen = sweeps.expand("packet_erasure", rounds=rounds)
    b, lp = len(scen), scen[0].lp
    meta = [dict(s.meta) for s in scen]
    pre = np.array([m["p_preempt"] for m in meta], np.float32)
    drop = np.array([m["p_drop"] for m in meta], np.float32)
    p_gg = np.array([s.p_gg for s in scen], np.float32)
    p_bb = np.array([s.p_bb for s in scen], np.float32)
    keys = np.array(jax.vmap(lambda i: jax.random.PRNGKey(1000 + i))(jnp.arange(b)))
    geometry = dict(rounds=rounds, strategies=("lea", "static"), r=meta[0]["r"],
                    packets=meta[0]["packets"], p1=meta[0]["p1"])
    jpool = jlea.PoolLoad(kstar=jnp.full((b,), lp.kstar, jnp.int32),
                          ell_g=jnp.full((b,), lp.ell_g, jnp.int32),
                          ell_b=jnp.full((b,), lp.ell_b, jnp.int32),
                          mask=jnp.ones((b, lp.n), bool))
    pool = PoolLoad(kstar=torch.tensor(lp.kstar, dtype=torch.int32),
                    ell_g=torch.tensor(lp.ell_g, dtype=torch.int32),
                    ell_b=torch.tensor(lp.ell_b, dtype=torch.int32),
                    mask=torch.ones(lp.n, dtype=torch.bool))
    spec = lambda a, d: [("preempt", {"p_preempt": a}), ("packet_bernoulli", {"p_drop": d})]
    jchannel = jfaults.make_channel(spec(jnp.asarray(pre), jnp.asarray(drop)))
    channel = faults.make_channel(spec(torch.from_numpy(pre), torch.from_numpy(drop)))
    common = (scen[0].mu_g, scen[0].mu_b, scen[0].deadline)
    jargs = (keys, jpool, jnp.asarray(p_gg), jnp.asarray(p_bb)) + common + (
        jchannel, meta[0]["k1star"])
    args = (pool, p_gg, p_bb) + common + (channel, meta[0]["k1star"])
    return keys, channel, jargs, args, geometry


def test_sweep_faults_on_the_packet_erasure_grid_matches_jax():
    """Outcomes equal ``repro``'s on replayed draws; a differing (row, round)
    can only come from an argmax tie the two DPs break apart (ROADMAP Queue
    C): at most 0.2% of the grid's rounds, 0 observed."""
    keys, channel, jargs, args, geometry = _grid(256)
    want = jfaults.sweep_faults(*jargs, **geometry)
    got = faults.sweep_faults(JaxFaultDraws(keys, channel), *args, **geometry, device=CPU)
    rows_rounds = keys.shape[0] * geometry["rounds"]
    for field in faults.FaultOutcomes._fields:
        g, w = getattr(got, field).numpy(), np.array(getattr(want, field))
        assert g.shape == w.shape == (keys.shape[0], geometry["rounds"], 2)
        flips = int((g != w).any(axis=-1).sum())
        assert flips <= rows_rounds // 500, f"{field}: {flips} rounds differ"
    aon, con, part = (x.numpy() for x in got)
    assert not (aon & ~con).any() and not (part & con).any()
    assert con.sum() > aon.sum()


def test_sweep_launches_the_allocator_once_for_the_grid(monkeypatch):
    """The whole grid is one pass: one allocator DP call, as one cell."""
    from repro_torch.core import lea

    calls = []
    real = lea.success_tails
    monkeypatch.setattr(lea, "success_tails", lambda p, w: calls.append(p.shape) or real(p, w))
    _, channel, _, args, geometry = _grid(64)
    faults.sweep_faults(3, *args, **geometry, device=CPU)
    grid_calls = len(calls)
    one = faults.simulate_faults(
        3, args[0], args[1][0], args[2][0], *args[3:6],
        faults.make_channel([("preempt", {"p_preempt": 0.2}),
                             ("packet_bernoulli", {"p_drop": 0.05})]),
        args[7], **geometry, device=CPU)
    assert grid_calls == len(calls) - grid_calls == 1
    assert one.full_aon.shape == (64, 2)


def test_empty_channel_one_packet_aon_is_simulate_strategies_pool():
    n, r, b, rounds = 8, 6, 3, 64
    pool = PoolLoad(kstar=torch.tensor(30, dtype=torch.int32),
                    ell_g=torch.tensor(6, dtype=torch.int32),
                    ell_b=torch.tensor(2, dtype=torch.int32),
                    mask=torch.ones(n, dtype=torch.bool))
    p_gg, p_bb = np.full((b, n), 0.8, np.float32), np.full((b, n), 0.7, np.float32)
    keys = np.array(jax.vmap(jax.random.PRNGKey)(jnp.arange(b)))
    strategies = ("lea", "static")
    for draws, ref_draws in ((JaxFaultDraws(keys), JaxDraws(keys)),
                             (torch_draws(4, CPU), torch_draws(4, CPU))):
        out = faults.sweep_faults(draws, pool, p_gg, p_bb, MU_G, MU_B, DEADLINE, (), 15,
                                  rounds=rounds, strategies=strategies, r=r, packets=1,
                                  device=CPU)
        ref = throughput.sweep_pool(ref_draws, pool, p_gg, p_bb, MU_G, MU_B, DEADLINE,
                                    rounds, strategies, device=CPU)
        assert torch.equal(out.full_aon, ref)
    jref = jax.vmap(lambda k: jtp.simulate_strategies_pool(
        k, jlea.PoolLoad(kstar=jnp.int32(30), ell_g=jnp.int32(6), ell_b=jnp.int32(2),
                         mask=jnp.ones((n,), bool)),
        jnp.full((n,), 0.8), jnp.full((n,), 0.7), MU_G, MU_B, DEADLINE, rounds,
        strategies=strategies))(jnp.asarray(keys))
    first = faults.sweep_faults(JaxFaultDraws(keys), pool, p_gg, p_bb, MU_G, MU_B, DEADLINE,
                                (), 15, rounds=rounds, strategies=strategies, r=r,
                                packets=1, device=CPU)
    np.testing.assert_array_equal(first.full_aon.numpy(), np.array(jref).astype(bool))


def test_telemetry_and_tap_name_the_observability_slice():
    """The flags return the observability slice's FaultTelemetry and
    faults.sweep events, and leave the outcomes as they are."""
    from repro_torch import obs
    _, _, _, args, geometry = _grid(8)
    off = faults.sweep_faults(0, *args, **geometry, device=CPU)
    with obs.capture_taps() as events:
        on, tel = faults.sweep_faults(0, *args, **geometry, device=CPU, telemetry=True,
                                      tap=True)
    assert isinstance(tel, faults.FaultTelemetry)
    for a, b in zip(off, on):
        assert torch.equal(a, b)
    assert [e["engine"] for e in events] == ["faults.sweep"] * len(off.full_aon)


def test_draws_protocols_are_checked_where_they_are_taken():
    """Sources built for the engine alone still pass ``as_draws``; a channel
    or ``thompson`` asks for the calls it needs."""
    engine_only = JaxDraws(np.array(jax.random.PRNGKey(0))[None])
    assert as_draws(engine_only, CPU) is engine_only
    assert not isinstance(engine_only, FaultDraws)
    tr = faults.base_trace(1, 4, 3, 2, 2, DEADLINE, device=CPU)
    with pytest.raises(TypeError, match="FaultDraws"):
        faults.apply_channel(engine_only, faults.make_channel(ALL_INJECTORS[:1]), tr)
    with pytest.raises(TypeError, match="BetaDraws"):
        throughput.simulate_strategies(engine_only, LoadParams(15, 99, 10, 3), [0.8] * 15,
                                       [0.7] * 15, MU_G, MU_B, DEADLINE, 8,
                                       ("thompson",), device=CPU)


def test_fault_and_beta_streams_leave_the_engine_uniforms_alone():
    lp = LoadParams(15, 99, 10, 3)
    args = (lp, [0.8] * 15, [0.7] * 15, MU_G, MU_B, DEADLINE, 200)
    alone = throughput.simulate_strategies(torch_draws(3, CPU), *args, ("lea", "static"),
                                           device=CPU)
    draws = torch_draws(3, CPU)
    with_thompson = throughput.simulate_strategies(draws, *args, ("lea", "thompson", "static"),
                                                   device=CPU)
    assert torch.equal(with_thompson[:, [0, 2]], alone)
    again = throughput.simulate_strategies(torch_draws(3, CPU), *args,
                                           ("lea", "thompson", "static"), device=CPU)
    assert torch.equal(again, with_thompson)


# ---------------------------------------------------------------------------
# thompson
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rounds", [1, 40])
def test_thompson_p_good_matches_jax_on_replayed_beta(rounds):
    rng = np.random.default_rng(rounds)
    n = 6
    states = rng.integers(0, 2, (rounds, n)).astype(np.int32)
    p = np.full(n, 0.7, np.float32)
    key = jax.random.PRNGKey(rounds)
    jctx = JPolicyContext(states=jnp.asarray(states), p_gg=jnp.asarray(p), p_bb=jnp.asarray(p),
                          pi_g=jnp.asarray(p), key=key)
    want = np.array(jregistry.resolve("thompson").p_good_trajectory(jctx))
    draws = JaxFaultDraws(np.array(key)[None], policy_root=np.array(key)[None])
    t = lambda a: torch.from_numpy(a)[None]
    ctx = PolicyContext(states=t(states), p_gg=t(p), p_bb=t(p), pi_g=t(p), draws=draws)
    got = registry.resolve("thompson").p_good_trajectory(ctx)
    assert draws.beta_calls == 2
    np.testing.assert_allclose(got[0].numpy(), want, rtol=1e-6, atol=0)


def test_thompson_in_the_engine_matches_jax():
    key = jax.random.PRNGKey(4)
    strategies = ("lea", "thompson", "static")
    want = np.array(jtp.simulate_strategies(
        key, jlea.LoadParams(15, 99, 10, 3), jnp.full((15,), 0.8), jnp.full((15,), 0.7),
        MU_G, MU_B, DEADLINE, 120, strategies=strategies))
    got = throughput.simulate_strategies(
        JaxFaultDraws(np.array(key)[None], policy_index=1), LoadParams(15, 99, 10, 3),
        [0.8] * 15, [0.7] * 15, MU_G, MU_B, DEADLINE, 120, strategies, device=CPU)
    np.testing.assert_array_equal(got.numpy(), want)
    assert registry.is_registered("thompson")
