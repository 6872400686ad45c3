"""The port's USCS ppzkSNARK with the USCS -> SSP reduction, and the TBCS
adapter on it, on device="cpu", against the JAX package and exact integers.

  * relations and reductions: USCS ``is_valid`` / ``is_satisfied``, the TBCS
    circuit's wires, outputs and validity, and ``tbcs_to_uscs`` (every one
    of the 16 gate types, the booleanity loop over variables 0 ..
    num_wires - 1 as the reference has it, the outputs) equal the JAX
    package's, on its ``_uscs_example`` and ``_tbcs_example``
    (tests/test_circuit_ppzksnarks.py) and on seeded circuits;
  * SSP host functions: ``ssp_domain_size``, the instance map at t (V(t),
    Z(t); the device's powers of t against the JAX ``Ht``) and
    ``assemble_v_evaluations`` equal the JAX package's on both curves;
  * SSP witness map: equal to the JAX ``witness_map`` limb for limb at a
    radix-2 domain of 16, with the prove's d and with d = 0 (the JAX map
    once a test session for all workers); on a step domain and on
    MNT6753's extended domain of 2^16, H(tau) Z(tau) = (V(tau) + d
    Z(tau))^2 - 1 at a random point by exact integers; a USCS of 17 (and
    of 3) constraints takes a step domain with a small part of size 1,
    where the JAX instance map raises (ops/fft.py:587) and the port's is
    held to exact Lagrange interpolation and the identity;
  * one key pair and proof on MNT4753 (once a test session): the TBCS
    generator and prover on a six-gate circuit, whose USCS has 16
    constraints and 9 variables.  The keys equal keys made from the same
    draws by the JAX instance map's scalars and tools/oracle.py's exact
    multiplication; the proof equals a replay of the JAX USCS assembly
    (uscs_ppzksnark.py:230-269) over tools/oracle.py's MSMs with the JAX
    witness map's H.  TBCS equals USCS on the lowered system: the adapter's
    one call of the USCS generator and of the USCS prover is recorded, with
    the system (the terms of ``tbcs_to_uscs.instance_map``), the state of
    the random generator (the seeds') and the wires it passes, and the key
    pair and proof it returns are the adapter's own; a second CPU run of
    the 753-bit chains would double this file's time;
  * verifiers: accept; reject a flipped primary bit, each of the four proof
    elements moved, a point off the curve; the strong IC's length check;
    a witness that breaks a constraint raises.

The JAX generator and prover are never run (their fixed-base and MSM
programs compile for minutes).  Every comparison is exact."""

import functools
import random

import numpy as np
import pytest
import torch

from snark_challenge_prover_tpu.models import mnt4753 as jax_mnt4753
from snark_challenge_prover_tpu.models import mnt6753 as jax_mnt6753
from snark_challenge_prover_tpu.ops import fft as jax_fft
from snark_challenge_prover_tpu.proof_systems import tbcs_ppzksnark as jax_tbcs_snark
from snark_challenge_prover_tpu.proof_systems import uscs_ppzksnark as jax_uscs_snark
from snark_challenge_prover_tpu.reductions import tbcs_to_uscs as jax_tbcs_to_uscs
from snark_challenge_prover_tpu.reductions import uscs_to_ssp as jax_ssp
from snark_challenge_prover_tpu.relations import r1cs as jax_r1cs
from snark_challenge_prover_tpu.relations import tbcs as jax_tbcs
from snark_challenge_prover_tpu.relations import uscs as jax_uscs
from snark_challenge_prover_tpu.utils.bigint import ints_to_limbs, limbs_to_int
from snark_challenge_prover_tpu_torch import convert
from snark_challenge_prover_tpu_torch.models import mnt4753, mnt6753
from snark_challenge_prover_tpu_torch.ops.fft import get_domain_of_min_size, power_table
from snark_challenge_prover_tpu_torch.proof_systems import tbcs_ppzksnark as port_tbcs_snark
from snark_challenge_prover_tpu_torch.proof_systems import uscs_ppzksnark as port_uscs_snark
from snark_challenge_prover_tpu_torch.reductions import tbcs_to_uscs as port_tbcs_to_uscs
from snark_challenge_prover_tpu_torch.reductions import uscs_to_ssp as port_ssp
from snark_challenge_prover_tpu_torch.relations import r1cs as port_r1cs
from snark_challenge_prover_tpu_torch.relations import tbcs as port_tbcs
from snark_challenge_prover_tpu_torch.relations import uscs as port_uscs
from snark_challenge_prover_tpu_torch.utils.bigint import words_to_ints
from test_torch_keygen import _once
from tools import oracle as orc

# one thread: the tensors here are small, and more threads only contend
# with the other workers of a parallel test run
torch.set_num_threads(1)

CURVES = ("MNT4753", "MNT6753")
JAX_MODELS = {"MNT4753": jax_mnt4753, "MNT6753": jax_mnt6753}
PORT_MODELS = {"MNT4753": mnt4753, "MNT6753": mnt6753}
CURVE, KEY_SEED, PROVE_SEED = "MNT4753", 7, 19  # the key pair's curve and seeds


# ---------------------------------------------------------------------------
# circuits, as plain data built in both packages
# ---------------------------------------------------------------------------

def circuit_spec(num_gates: int, primary: int, auxiliary: int, outputs: int, seed: int):
    """A satisfiable TBCS circuit drawn from ``seed``: (gates as (left,
    right, type, output, is_circuit_output), primary bits, auxiliary bits).
    The first gates take the 16 types in a shuffled order with wire 0 (TRUE)
    on the left; then random types over earlier wires (0 included); the last
    ``outputs`` gates are circuit outputs, each given the complement of its
    drawn type where that type evaluates to true, so every output is false."""
    rng = random.Random(seed)
    wires = [rng.randrange(2) for _ in range(primary + auxiliary)]
    types = list(range(16))
    rng.shuffle(types)
    gates = []
    for j in range(num_gates):
        n = len(wires)
        left = 0 if j < 16 else rng.randrange(n + 1)
        right = rng.randrange(n + 1)
        kind = types[j] if j < 16 else rng.randrange(16)
        is_out = j >= num_gates - outputs
        value = port_tbcs.TBCSGate(left, right, kind, n + 1).evaluate(wires)
        if is_out and value:
            kind, value = kind ^ 15, not value
        gates.append((left, right, kind, n + 1, is_out))
        wires.append(int(value))
    return gates, wires[:primary], wires[primary : primary + auxiliary]


def build_circuit(mod, gates, primary: int, auxiliary: int):
    circuit = mod.TBCSCircuit(primary_input_size=primary, auxiliary_input_size=auxiliary)
    for g in gates:
        circuit.add_gate(mod.TBCSGate(*g))
    return circuit


def tbcs_case(case: str):
    """(JAX circuit, port circuit, primary bits, auxiliary bits)."""
    if case == "tbcs_example":  # tests/test_circuit_ppzksnarks.py:_tbcs_example
        gates = [(1, 2, 6, 3, True), (1, 3, 1, 4, False), (4, 4, 2, 5, True)]
        sizes, primary, auxiliary = (1, 1), [True], [True]
    elif case == "key":  # the key pair's: 2 * 6 + 3 + 1 = 16 constraints, 9 variables
        gates, primary, auxiliary = circuit_spec(6, 1, 2, 1, KEY_SEED)
        sizes = (1, 2)
    else:  # "seeded": every gate type, 2 * 20 + 5 + 2 = 47 constraints
        gates, primary, auxiliary = circuit_spec(20, 2, 3, 2, 20)
        sizes = (2, 3)
    return (build_circuit(jax_tbcs, gates, *sizes), build_circuit(port_tbcs, gates, *sizes),
            primary, auxiliary)


def uscs_example(mod, r1cs_mod, p: int):
    """tests/test_circuit_ppzksnarks.py:_uscs_example: x1 = x2 = 1 under
    2 x1 - 1, 2 x2 - 1 and x1 + x2 - 1."""
    cs = mod.USCSConstraintSystem(p, primary_input_size=1, auxiliary_input_size=1)
    LC = r1cs_mod.LinearCombination
    for terms in ([(1, 2), (0, -1)], [(2, 2), (0, -1)], [(1, 1), (2, 1), (0, -1)]):
        cs.add_constraint(LC(terms))
    return cs, [1], [1]


def lowered(case: str, name: str = CURVE):
    """(JAX USCS, port USCS, primary, auxiliary) of a TBCS case lowered by
    each package's ``tbcs_to_uscs``."""
    jc, pc, primary, auxiliary = tbcs_case(case)
    p = JAX_MODELS[name].get().Fr.p
    wires = port_tbcs_to_uscs.witness_map(pc, primary, auxiliary)
    k = len(primary)
    return (jax_tbcs_to_uscs.instance_map(jc, p), port_tbcs_to_uscs.instance_map(pc, p),
            wires[:k], wires[k:])


def _terms(cs):
    return [lc.terms for lc in cs.constraints]


# ---------------------------------------------------------------------------
# relations and reductions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["tbcs_example", "key", "seeded"])
def test_tbcs_relation_matches_jax(case):
    jc, pc, primary, auxiliary = tbcs_case(case)
    assert (pc.num_inputs, pc.num_gates, pc.num_wires) == (jc.num_inputs, jc.num_gates, jc.num_wires)
    assert pc.is_valid() and jc.is_valid()
    assert pc.get_all_wires(primary, auxiliary) == jc.get_all_wires(primary, auxiliary)
    assert pc.get_all_outputs(primary, auxiliary) == jc.get_all_outputs(primary, auxiliary)
    assert not any(pc.get_all_outputs(primary, auxiliary))
    assert pc.is_satisfied(primary, auxiliary) and jc.is_satisfied(primary, auxiliary)
    if case == "seeded":
        assert {g.type for g in pc.gates} == set(range(16))
        assert any(0 in (g.left_wire, g.right_wire) for g in pc.gates)
    # some flipped input makes an output true in both packages alike
    verdicts = []
    for i in range(len(primary) + len(auxiliary)):
        bits = [int(b) for b in primary + auxiliary]
        bits[i] ^= 1
        bad_p, bad_a = bits[: len(primary)], bits[len(primary):]
        verdicts.append(pc.is_satisfied(bad_p, bad_a))
        assert verdicts[-1] == jc.is_satisfied(bad_p, bad_a)
    assert not all(verdicts)


def test_invalid_tbcs_circuit_refused():
    _, pc, _, _ = tbcs_case("key")
    with pytest.raises(ValueError, match="in order"):
        pc.add_gate(port_tbcs.TBCSGate(1, 1, 6, pc.num_wires + 2))
    pc.gates[0].right_wire = pc.num_wires  # a wire not yet assigned
    assert not pc.is_valid()
    with pytest.raises(ValueError):
        port_tbcs_to_uscs.instance_map(pc, JAX_MODELS[CURVE].get().Fr.p)
    _, pc, _, _ = tbcs_case("key")
    pc.gates[-1].type = 16
    assert not pc.is_valid()


@pytest.mark.parametrize("name", CURVES)
@pytest.mark.parametrize("kind", range(16))
def test_gate_constraint_matches_jax(kind, name):
    """One gate of each type: the constraint's terms are the JAX package's,
    and on boolean x, y it holds exactly for z = type(x, y), in both."""
    p = JAX_MODELS[name].get().Fr.p
    circuits = [build_circuit(mod, [(1, 2, kind, 3, False)], 2, 0) for mod in (jax_tbcs, port_tbcs)]
    jcs, cs = (m.instance_map(c, p) for m, c in zip((jax_tbcs_to_uscs, port_tbcs_to_uscs), circuits))
    assert _terms(cs) == _terms(jcs)
    for x in (0, 1):
        for y in (0, 1):
            wires = port_tbcs_to_uscs.witness_map(circuits[1], [x, y], [])
            assert wires == jax_tbcs_to_uscs.witness_map(circuits[0], [x, y], [])
            assert wires[2] == (kind >> (3 - (2 * x + y))) & 1
            bad = wires[:2] + [1 - wires[2]]
            for system in (cs, jcs):
                assert system.is_satisfied(wires[:2], wires[2:])
                assert not system.is_satisfied(bad[:2], bad[2:])


@pytest.mark.parametrize("name", CURVES)
@pytest.mark.parametrize("case", ["tbcs_example", "key", "seeded"])
def test_tbcs_to_uscs_matches_jax(case, name):
    jc, pc, primary, auxiliary = tbcs_case(case)
    jcs, cs, w_primary, w_aux = lowered(case, name)
    G, I, W = pc.num_gates, pc.num_inputs, pc.num_wires
    O = sum(g.is_circuit_output for g in pc.gates)
    assert _terms(cs) == _terms(jcs) and cs.num_constraints == 2 * G + I + O
    assert (cs.primary_input_size, cs.auxiliary_input_size) == (jcs.primary_input_size,
                                                                jcs.auxiliary_input_size)
    assert cs.num_variables == W
    # the booleanity loop over variables 0 .. num_wires - 1 (the reference's
    # tcc:138-142): the constant ONE's, and none for the last wire
    boolean = _terms(cs)[G : G + W]
    assert boolean == [[(i, 2), (0, -1)] for i in range(W)]
    assert all((W, 2) not in terms for terms in boolean)
    assert _terms(cs)[G + W :] == [[(g.output, 1), (0, 1)] for g in pc.gates if g.is_circuit_output]
    wires = port_tbcs_to_uscs.witness_map(pc, primary, auxiliary)
    assert wires == jax_tbcs_to_uscs.witness_map(jc, primary, auxiliary) == w_primary + w_aux
    assert cs.is_satisfied(w_primary, w_aux) and jcs.is_satisfied(w_primary, w_aux)
    assert convert.tbcs_circuit_from_reference(jc).get_all_wires(primary, auxiliary) == \
        pc.get_all_wires(primary, auxiliary)


def test_uscs_relation_matches_jax():
    p = JAX_MODELS[CURVE].get().Fr.p
    (jcs, primary, auxiliary), (cs, _, _) = (uscs_example(m, r, p) for m, r in
                                             ((jax_uscs, jax_r1cs), (port_uscs, port_r1cs)))
    assert _terms(convert.uscs_from_reference(jcs)) == _terms(cs)
    assert (cs.num_variables, cs.num_constraints) == (jcs.num_variables, jcs.num_constraints) == (2, 3)
    assert cs.is_valid() and jcs.is_valid()
    for aux in ([1], [2], [p - 1], [0]):
        assert cs.is_satisfied(primary, aux) == jcs.is_satisfied(primary, aux) == (aux == [1])
    # -1 is as good as +1: 2 x - 1 = -1 at x = 0
    half = port_uscs.USCSConstraintSystem(p, 1, 0)
    half.add_constraint(port_r1cs.LinearCombination([(1, 2), (0, -1)]))
    assert half.is_satisfied([0], []) and half.is_satisfied([1], []) and not half.is_satisfied([2], [])
    cs.add_constraint(port_r1cs.LinearCombination([(3, 1)]))  # a variable beyond the system's
    assert not cs.is_valid()
    assert port_uscs.USCSConstraintSystem(p, 3, 0).is_valid()  # no constraints


# ---------------------------------------------------------------------------
# SSP host functions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", CURVES)
@pytest.mark.parametrize("case", ["tbcs_example", "key", "seeded"])
def test_ssp_host_functions_match_jax(name, case):
    jcs, cs, primary, auxiliary = lowered(case, name)
    jF, F = JAX_MODELS[name].get().Fr, PORT_MODELS[name].get("cpu").Fr
    n = port_ssp.ssp_domain_size(cs, F)
    assert n == jax_ssp.ssp_domain_size(jcs, jF) >= cs.num_constraints
    t = random.Random(n).randrange(1, F.p)
    got, want = port_ssp.instance_map_with_evaluation(cs, t, F), \
        jax_ssp.instance_map_with_evaluation(jcs, t, jF)
    for key in ("domain_size", "num_variables", "num_inputs", "t", "Vt", "Zt"):
        assert getattr(got, key) == getattr(want, key), key
    assert words_to_ints(F.to_canonical(power_table(F, t, n + 1)).numpy()) == want.Ht
    full = [v % F.p for v in primary + auxiliary]
    aV = port_ssp.assemble_v_evaluations(cs, full, F)
    assert aV == jax_ssp.assemble_v_evaluations(jcs, full, jF)
    assert len(aV) == n and all(v in (1, F.p - 1) for v in aV)


# ---------------------------------------------------------------------------
# SSP witness map
# ---------------------------------------------------------------------------

def prove_d(name: str = CURVE) -> int:
    """The prover's d, its first draw."""
    return random.Random(PROVE_SEED).randrange(JAX_MODELS[name].get().Fr.p)


def _jax_witness_maps():
    """The JAX SSP witness map of the key's USCS with the prove's d and with
    d = 0: (full assignment, H planes) each.  Its ``partial`` is memoised
    for the two calls, so that ``jax.jit`` meets the same function twice and
    traces it once (a second trace costs about 9 s)."""
    jcs, _, primary, auxiliary = lowered("key")
    out = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_ssp, "partial", functools.lru_cache(maxsize=None)(functools.partial))
        for d in (prove_d(), 0):
            wit = jax_ssp.witness_map(JAX_MODELS[CURVE].get(), jcs, primary, auxiliary, d)
            out.append((wit.full_assignment, np.asarray(wit.H_planes)))
    return out


def jax_witness_maps(tmp_path_factory):
    return _once(tmp_path_factory, f"jax-ssp-witness-map-{CURVE}",
                 lambda d: _jax_witness_maps())[1]


@pytest.mark.parametrize("patched", [True, False])
def test_witness_map_is_the_jax_packages(tmp_path_factory, patched):
    want_full, want_H = jax_witness_maps(tmp_path_factory)[0 if patched else 1]
    _, cs, primary, auxiliary = lowered("key")
    d = prove_d() if patched else 0
    wit = port_ssp.witness_map(mnt4753.get("cpu"), cs, primary, auxiliary, d)
    assert (wit.degree, wit.num_inputs, wit.num_variables, wit.d) == (16, 1, 9, d)
    assert wit.full_assignment == want_full
    assert wit.H.shape == (24, 17) and wit.H.dtype == torch.int32
    assert torch.equal(wit.H, convert.tensor_from_planes(want_H, "cpu"))


def _at_tau(xs, p: int, tau: int):
    """(Z(tau), values on the points xs -> their polynomial at tau), by
    exact integers: L_i(tau) = Z(tau) / ((tau - x_i) Z'(x_i)), Z'(x_i) the
    product of x_i - x_j over the other points."""
    z = 1
    for x in xs:
        z = z * (tau - x) % p
    weights = []
    for i, xi in enumerate(xs):
        den = tau - xi
        for j, xj in enumerate(xs):
            if j != i:
                den = den * (xi - xj) % p
        weights.append(z * pow(den, -1, p) % p)
    return z, lambda vals: sum(v * w for v, w in zip(vals, weights)) % p


def _extended_at_tau(domain, p: int, tau: int):
    """The same for an extended radix-2 domain of n = 2 m points, omega^i
    then s omega^i (i < m), read off the domain's elements 1 and m and held
    to 64 more of them: Z(x) = (x^m - 1)(x^m - s^m), so Z'(x_i) is
    m (1 - s^m) / x_i on the first half and m s^m (s^m - 1) / x_i on the
    second; Z(tau) is checked against the product over the points."""
    n = domain.n
    m = n // 2
    omega, s = domain.get_domain_element(1), domain.get_domain_element(m)
    xs, x = [], 1
    for _ in range(m):
        xs.append(x)
        x = x * omega % p
    xs += [s * x % p for x in xs]
    for i in random.Random(n).sample(range(n), 64):
        assert domain.get_domain_element(i) == xs[i]
    sm = pow(s, m, p)
    z = (pow(tau, m, p) - 1) * (pow(tau, m, p) - sm) % p
    prod = 1
    for x in xs:
        prod = prod * (tau - x) % p
    assert prod == z
    # w_i = Z(tau) / ((tau - x_i) Z'(x_i)) = Z(tau) x_i / ((tau - x_i) m c), one inversion
    c = [m * (1 - sm) % p, m * sm * (sm - 1) % p]
    dens = [(tau - x) * c[i >= m] % p for i, x in enumerate(xs)]
    acc, prefix = 1, []
    for v in dens:
        prefix.append(acc)
        acc = acc * v % p
    inv, weights = pow(acc, -1, p), [0] * n
    for i in range(n - 1, -1, -1):
        weights[i] = z * xs[i] % p * inv * prefix[i] % p
        inv = inv * dens[i] % p
    return z, lambda vals: sum(v * w for v, w in zip(vals, weights)) % p


def _check_identity(name: str, cs, primary, auxiliary, kind: str, n: int, seed: int):
    """The port's patched witness map on ``cs``: its domain is a ``kind`` of
    n points (the JAX package's too), its top coefficient d^2, and H(tau)
    Z(tau) = (V(tau) + d Z(tau))^2 - 1 at a random tau, V through the JAX
    domain's points."""
    model = PORT_MODELS[name].get("cpu")
    p = model.Fr.p
    rng = random.Random(seed)
    d = rng.randrange(1, p)
    wit = port_ssp.witness_map(model, cs, primary, auxiliary, d)
    assert wit.H.shape == (24, n + 1)
    domain = jax_fft.get_evaluation_domain(JAX_MODELS[name].get().Fr, n)
    assert type(domain).__name__ == type(get_domain_of_min_size(model.Fr, n)).__name__ == kind
    tau = rng.randrange(p)
    if kind == "ExtendedRadix2Domain":
        z, at_tau = _extended_at_tau(domain, p, tau)
    else:
        z, at_tau = _at_tau([domain.get_domain_element(i) for i in range(n)], p, tau)
    V = at_tau(port_ssp.assemble_v_evaluations(cs, wit.full_assignment, model.Fr))
    coeffs = words_to_ints(model.Fr.to_canonical(wit.H).numpy())
    assert coeffs[n] == d * d % p
    h = 0
    for coeff in reversed(coeffs):
        h = (h * tau + coeff) % p
    assert h * z % p == ((V + d * z) ** 2 - 1) % p
    return at_tau


@pytest.mark.parametrize("name,gates,inputs,outputs,kind,n", [
    ("MNT4753", 8, 5, 3, "StepRadix2Domain", 24),
    ("MNT6753", 32762, 10, 2, "ExtendedRadix2Domain", 1 << 16)])
def test_patched_witness_map_on_other_domains(name, gates, inputs, outputs, kind, n):
    """A step domain (MNT4753, 24 = 16 + 8 points) and MNT6753's extended
    domain (2^16 points, twice its largest radix-2 domain), each exactly
    filled by a lowered TBCS circuit of 2 G + I + O constraints."""
    gates_, primary, auxiliary = circuit_spec(gates, 2, inputs - 2, outputs, n)
    pc = build_circuit(port_tbcs, gates_, 2, inputs - 2)
    cs = port_tbcs_to_uscs.instance_map(pc, PORT_MODELS[name].get("cpu").Fr.p)
    assert cs.num_constraints == n
    wires = port_tbcs_to_uscs.witness_map(pc, primary, auxiliary)
    _check_identity(name, cs, wires[:2], wires[2:], kind, n, n)


@pytest.mark.parametrize("name,num_constraints", [("MNT4753", 17), ("MNT6753", 17), ("MNT4753", 3)])
def test_step_domain_with_a_small_part_of_size_one(name, num_constraints):
    """A USCS of 2^k + 1 constraints: the step domain's small part has one
    point.  The JAX instance map raises there (ops/fft.py:587); the port's
    V(t) and Z(t) equal exact Lagrange interpolation through the JAX
    domain's points, and its witness map holds the identity.  Three
    constraints: the JAX package's own ``_uscs_example``."""
    p = JAX_MODELS[name].get().Fr.p
    jF, F = JAX_MODELS[name].get().Fr, PORT_MODELS[name].get("cpu").Fr
    if num_constraints == 3:
        (jcs, primary, auxiliary), (cs, _, _) = (uscs_example(m, r, p) for m, r in
                                                 ((jax_uscs, jax_r1cs), (port_uscs, port_r1cs)))
    else:  # 2 * 4 + 6 + 3 = 17
        gates, primary, auxiliary = circuit_spec(4, 2, 4, 3, 17)
        jcs, cs = (tr.instance_map(build_circuit(mod, gates, 2, 4), p) for mod, tr in
                   ((jax_tbcs, jax_tbcs_to_uscs), (port_tbcs, port_tbcs_to_uscs)))
        wires = port_tbcs_to_uscs.witness_map(build_circuit(port_tbcs, gates, 2, 4), primary,
                                              auxiliary)
        primary, auxiliary = wires[:2], wires[2:]
    n = num_constraints
    assert port_ssp.ssp_domain_size(cs, F) == jax_ssp.ssp_domain_size(jcs, jF) == n
    t = random.Random(n).randrange(1, p)
    with pytest.raises(Exception):
        jax_ssp.instance_map_with_evaluation(jcs, t, jF)
    got = port_ssp.instance_map_with_evaluation(cs, t, F)
    domain = jax_fft.get_evaluation_domain(jF, n)
    z, at_t = _at_tau([domain.get_domain_element(i) for i in range(n)], p, t)
    # V_i(t): variable i's coefficient in each row, through the basis
    rows = [{} for _ in range(cs.num_variables + 1)]
    for j, lc in enumerate(cs.constraints):
        for idx, coeff in lc.terms:
            rows[idx][j] = rows[idx].get(j, 0) + coeff
    want = [at_t([row.get(j, 0) for j in range(n)]) for row in rows]
    assert got.Zt == z and got.Vt == want and got.domain_size == n
    _check_identity(name, cs, primary, auxiliary, "StepRadix2Domain", n, n + 1)


# ---------------------------------------------------------------------------
# the key pair and the proof: TBCS on MNT4753, which is USCS on the lowered
# system
# ---------------------------------------------------------------------------

def _planes(spec, values):
    return ints_to_limbs([spec.to_mont(v) for v in values])


def expected_keys():
    """The JAX USCS generator's keys (uscs_ppzksnark.py:86-167) on the key
    circuit's USCS for ``KEY_SEED``, by the JAX instance map's scalars and
    tools/oracle.py's exact group law (the identity stored as (0, 0)), as
    JAX ``ProvingKey`` / ``VerificationKey``, with the secrets."""
    cur = orc.ORACLES[CURVE]()
    Fr, spec = JAX_MODELS[CURVE].get().Fr, JAX_MODELS[CURVE].get().Fq.spec
    p = Fr.p
    jcs = lowered("key")[0]
    rng = random.Random(KEY_SEED)
    t = rng.randrange(1, p)
    inst = jax_ssp.instance_map_with_evaluation(jcs, t, Fr)
    m, n, l = inst.num_variables, inst.domain_size, inst.num_inputs
    table = list(inst.Vt) + [inst.Zt]
    alpha, tilde = rng.randrange(1, p), rng.randrange(1, p)
    G, H = cur.g1_gen, cur.g2_gen

    def g1_pair(scalars):
        pts = [cur.g1.mul(s % p, G) for s in scalars]
        return (_planes(spec, [0 if P is None else P[0] for P in pts]),
                _planes(spec, [0 if P is None else P[1] for P in pts]))

    def g2_pair(scalars):
        pts = [cur.g2.mul(s % p, H) for s in scalars]
        comp = lambda k: np.stack([_planes(spec, [0 if P is None else P[k][c] for P in pts])
                                   for c in range(cur.ext_deg)])
        return comp(0), comp(1)

    jpk = jax_uscs_snark.ProvingKey(
        curve=CURVE, V_g1_query=g1_pair(table[l + 1 :]),
        alpha_V_g1_query=g1_pair([alpha * v for v in table[l + 1 :]]),
        H_g1_query=g1_pair(inst.Ht[: n + 1]), V_g2_query=g2_pair(table), constraint_system=jcs)
    jvk = jax_uscs_snark.VerificationKey(
        curve=CURVE, tilde_g2=cur.g2.mul(tilde, H), alpha_tilde_g2=cur.g2.mul(alpha * tilde % p, H),
        Z_g2=cur.g2.mul(inst.Zt, H), encoded_IC_base=cur.g1.mul(table[0], G),
        encoded_IC_values=[cur.g1.mul(v, G) for v in table[1 : l + 1]])
    secrets = {"t": t, "alpha": alpha, "table": table, "n": n, "m": m, "l": l}
    return jpk, jvk, secrets


_EXPECTED = {}


def expected():
    if not _EXPECTED:
        _EXPECTED["keys"] = expected_keys()
    return _EXPECTED["keys"]


def _prove():
    """The TBCS generator and prover on the key circuit, with the adapter's
    calls of the USCS generator and prover recorded: the system's terms,
    the random generator's state on entry, the wires passed and what each
    returned."""
    _, pc, primary, auxiliary = tbcs_case("key")
    model = PORT_MODELS[CURVE].get("cpu")
    calls = {}

    def spy(name, real):
        def wrapped(model, system_or_pk, *args):
            *args, rng, profiler = args
            cs = system_or_pk if name == "generator" else system_or_pk.constraint_system
            calls[name] = {"terms": _terms(cs), "rng_state": rng.getstate(), "args": args}
            calls[name]["result"] = real(model, system_or_pk, *args, rng, profiler)
            return calls[name]["result"]
        return wrapped

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_uscs_snark, "generator", spy("generator", port_uscs_snark.generator))
        mp.setattr(port_uscs_snark, "prover", spy("prover", port_uscs_snark.prover))
        kp = port_tbcs_snark.generator(model, pc, random.Random(KEY_SEED))
        proof = port_tbcs_snark.prover(model, kp.pk, primary, auxiliary, random.Random(PROVE_SEED))
    # the adapter hands back what USCS returned, itself
    calls["generator"]["returned_as_is"] = (kp.vk is calls["generator"]["result"].vk
                                            and kp.pk.uscs_pk is calls["generator"]["result"].pk)
    calls["prover"]["returned_as_is"] = proof is calls["prover"]["result"]
    for call in calls.values():
        del call["result"]
    return kp, proof, calls


def proved(tmp_path_factory):
    """The port's TBCS key pair, proof and recorded USCS calls on the CPU,
    once a test session."""
    return _once(tmp_path_factory, f"tbcs-uscs-prove-{CURVE}", lambda d: _prove())[1]


QUERIES = ("V_g1_query", "alpha_V_g1_query", "H_g1_query", "V_g2_query")


def test_keys_are_the_jax_replay(tmp_path_factory):
    kp, _, _ = proved(tmp_path_factory)
    jpk, jvk, sec = expected()
    pk, want = kp.pk.uscs_pk, convert.uscs_proving_key_from_jax(jpk, "cpu")
    for key in QUERIES:
        for got_c, want_c in zip(getattr(pk, key), getattr(want, key)):
            assert got_c.dtype == torch.int32 and torch.equal(got_c, want_c), key
    m, l, n = sec["m"], sec["l"], sec["n"]
    assert pk.V_g1_query[0].shape == (24, m - l + 1) and pk.H_g1_query[0].shape == (24, n + 1)
    assert pk.V_g2_query[0].shape == (2, 24, m + 2)
    assert kp.vk == convert.uscs_verification_key_from_jax(jvk)
    assert len(kp.vk.encoded_IC_values) == l == 1


def test_tbcs_key_is_the_jax_packages(tmp_path_factory):
    """The TBCS proving key carries the circuit and the USCS key, as the JAX
    package's does (``convert.tbcs_proving_key_from_jax``)."""
    kp, _, _ = proved(tmp_path_factory)
    jc, _, primary, auxiliary = tbcs_case("key")
    jpk = expected()[0]
    want = convert.tbcs_proving_key_from_jax(
        jax_tbcs_snark.ProvingKey(circuit=jc, uscs_pk=jpk), "cpu")
    assert want.circuit.get_all_wires(primary, auxiliary) == \
        kp.pk.circuit.get_all_wires(primary, auxiliary)
    assert _terms(want.uscs_pk.constraint_system) == _terms(kp.pk.uscs_pk.constraint_system)
    for key in QUERIES:
        assert all(torch.equal(a, b) for a, b in zip(getattr(want.uscs_pk, key),
                                                     getattr(kp.pk.uscs_pk, key)))


def _h_coefficients(planes) -> list:
    """The JAX witness map's Montgomery planes -> canonical coefficients."""
    spec = JAX_MODELS[CURVE].get().Fr.spec
    return [spec.from_mont(limbs_to_int(planes[:, i])) for i in range(planes.shape[1])]


def replay_proof(tmp_path_factory):
    """The JAX assembly (uscs_ppzksnark.py:230-269) over tools/oracle.py's
    MSMs of the expected key's points, H the JAX witness map's with the
    prove's d; checked on the way against the scalars V(t) + d Z(t) and
    H(t) with no MSM."""
    cur = orc.ORACLES[CURVE]()
    p = cur.fr_spec.p
    _, _, sec = expected()
    _, _, primary, auxiliary = lowered("key")
    d = prove_d()
    full, planes = jax_witness_maps(tmp_path_factory)[0]
    h = _h_coefficients(planes)
    w = [v % p for v in full]
    table, m, l, t = sec["table"], sec["m"], sec["l"], sec["t"]
    nv = m - l
    G, H = cur.g1_gen, cur.g2_gen
    g1 = lambda s: cur.g1.mul(s % p, G)
    Vq = [g1(v) for v in table[l + 1 :]]
    aVq = [g1(sec["alpha"] * v) for v in table[l + 1 :]]
    V2q = [cur.g2.mul(v, H) for v in table]
    V_g1 = cur.g1.add(cur.g1.mul(d, Vq[nv]), cur.g1.msm(w[l:], Vq[:nv]))
    alpha_V_g1 = cur.g1.add(cur.g1.mul(d, aVq[nv]), cur.g1.msm(w[l:], aVq[:nv]))
    H_g1 = cur.g1.msm(h, [g1(pow(t, i, p)) for i in range(len(h))])
    V_g2 = cur.g2.add(cur.g2.add(V2q[0], cur.g2.mul(d, V2q[m + 1])),
                      cur.g2.msm(w, V2q[1 : m + 1]))
    # the same points from the scalars at t
    Zt = table[m + 1]
    Vt = (table[0] + sum(wi * v for wi, v in zip(w, table[1 : m + 1]))) % p
    V_rest = sum(wi * v for wi, v in zip(w[l:], table[l + 1 : m + 1])) % p
    h_t = ((Vt + d * Zt) ** 2 - 1) * pow(Zt, -1, p) % p
    assert (V_g1, alpha_V_g1, H_g1, V_g2) == (
        g1(V_rest + d * Zt), g1(sec["alpha"] * (V_rest + d * Zt)), g1(h_t),
        cur.g2.mul((Vt + d * Zt) % p, H))
    return jax_uscs_snark.Proof(V_g1=V_g1, alpha_V_g1=alpha_V_g1, H_g1=H_g1, V_g2=V_g2)


def test_proof_is_the_jax_replay(tmp_path_factory):
    _, proof, _ = proved(tmp_path_factory)
    assert proof == convert.uscs_proof_from_jax(replay_proof(tmp_path_factory))


def test_tbcs_is_uscs_on_the_lowered_system(tmp_path_factory):
    """The adapter runs the USCS generator once on ``instance_map`` of the
    circuit with the key seed's generator untouched, and the USCS prover
    once with the circuit's wires as 0/1 (the primary bits first) and the
    prove seed's generator; the key pair and the proof are what those
    calls returned, unchanged (and the replay above holds them to the USCS
    formulas)."""
    _, _, calls = proved(tmp_path_factory)
    jcs, cs, primary, auxiliary = lowered("key")
    gen, prv = calls["generator"], calls["prover"]
    assert gen["terms"] == _terms(cs) == _terms(jcs)
    assert gen["rng_state"] == random.Random(KEY_SEED).getstate() and gen["args"] == []
    assert prv["terms"] == _terms(cs)
    assert prv["rng_state"] == random.Random(PROVE_SEED).getstate()
    assert prv["args"] == [primary, auxiliary] and set(primary + auxiliary) <= {0, 1}
    assert gen["returned_as_is"] and prv["returned_as_is"]


def test_unsatisfied_witness_raises(tmp_path_factory):
    """Inputs that make an output true (through the TBCS prover), or a wire
    flipped (the USCS prover directly), raise before any group work."""
    kp, _, _ = proved(tmp_path_factory)
    _, pc, primary, auxiliary = tbcs_case("key")
    model = mnt4753.get("cpu")
    bad = None
    for i in range(len(auxiliary)):
        flipped = list(auxiliary)
        flipped[i] ^= 1
        if not pc.is_satisfied(primary, flipped):
            bad = flipped
    assert bad is not None
    with pytest.raises(ValueError, match="does not satisfy"):
        port_tbcs_snark.prover(model, kp.pk, primary, bad, random.Random(1))
    wires = port_tbcs_to_uscs.witness_map(pc, primary, auxiliary)
    wires[-1] ^= 1  # the output gate's wire
    with pytest.raises(ValueError, match="does not satisfy"):
        port_uscs_snark.prover(model, kp.pk.uscs_pk, wires[:1], wires[1:], random.Random(1))


def test_proof_verifies(tmp_path_factory):
    kp, proof, _ = proved(tmp_path_factory)
    primary = tbcs_case("key")[2]
    assert port_tbcs_snark.verifier_strong_IC(kp.vk, primary, proof)
    assert port_tbcs_snark.online_verifier_weak_IC(kp.vk, primary, proof)
    jvk = expected()[1]
    assert jax_tbcs_snark.verifier_strong_IC(jvk, primary, jax_uscs_snark.Proof(**vars(proof)))


def test_flipped_primary_bit_rejected(tmp_path_factory):
    kp, proof, _ = proved(tmp_path_factory)
    bad = [1 - b for b in tbcs_case("key")[2]]
    assert not port_tbcs_snark.verifier_strong_IC(kp.vk, bad, proof)
    assert not jax_tbcs_snark.verifier_strong_IC(expected()[1], bad,
                                                 jax_uscs_snark.Proof(**vars(proof)))


def test_strong_ic_length_check(tmp_path_factory):
    kp, proof, _ = proved(tmp_path_factory)
    primary = tbcs_case("key")[2]
    assert not port_tbcs_snark.verifier_strong_IC(kp.vk, primary[:0], proof)
    assert not port_uscs_snark.online_verifier_strong_IC(kp.vk, [1, 0], proof)
    with pytest.raises(ValueError):
        port_uscs_snark.verifier_weak_IC(kp.vk, [1, 0], proof)


@pytest.mark.parametrize("part", ["V_g1", "alpha_V_g1", "H_g1", "V_g2"])
def test_tampered_proof_rejected(tmp_path_factory, part):
    """Each element moved by a generator: one of the three checks sees it."""
    kp, proof, _ = proved(tmp_path_factory)
    cur = orc.ORACLES[CURVE]()
    group, gen = (cur.g2, cur.g2_gen) if part == "V_g2" else (cur.g1, cur.g1_gen)
    bad = port_uscs_snark.Proof(**{**vars(proof), part: group.add(getattr(proof, part), gen)})
    assert not port_tbcs_snark.verifier_strong_IC(kp.vk, tbcs_case("key")[2], bad)


def test_proof_off_curve_rejected(tmp_path_factory):
    kp, proof, _ = proved(tmp_path_factory)
    cur = orc.ORACLES[CURVE]()
    assert all(cur.g1.is_on_curve(P) for P in (proof.V_g1, proof.alpha_V_g1, proof.H_g1))
    assert cur.g2.is_on_curve(proof.V_g2)
    x, y = proof.H_g1
    off = port_uscs_snark.Proof(**{**vars(proof), "H_g1": (x, (y + 1) % cur.fq_spec.p)})
    assert not port_tbcs_snark.verifier_strong_IC(kp.vk, tbcs_case("key")[2], off)
