"""The port's relations and R1CS -> QAP reduction (host integers) against
the JAX package's, under the same seeds: the examples' constraints (every
term, in order), assignments and draws from the generator, the
satisfiability check and swap_AB_if_beneficial; the instance map at t and
the domain evaluations of A, B and C over radix-2, step and mixed-radix
domains; qap_domain_size; the JAX instance map's powers of t against the
port's ``power_table``."""

import random

import pytest
import torch

from snark_challenge_prover_tpu.models import mnt4753 as jax_mnt4753
from snark_challenge_prover_tpu.models import mnt6753 as jax_mnt6753
from snark_challenge_prover_tpu.reductions import r1cs_to_qap as jax_qap
from snark_challenge_prover_tpu.relations import examples as jax_examples
from snark_challenge_prover_tpu_torch.models import mnt4753, mnt6753
from snark_challenge_prover_tpu_torch.ops.fft import power_table
from snark_challenge_prover_tpu_torch.reductions import r1cs_to_qap as port_qap
from snark_challenge_prover_tpu_torch.relations import examples as port_examples
from snark_challenge_prover_tpu_torch.utils.bigint import words_to_ints

# one thread: the tensors here are small, and more threads only contend
# with the other workers of a parallel test run
torch.set_num_threads(1)

P = mnt4753.FIELD_A.p
MODELS = {"MNT4753": (jax_mnt4753, mnt4753), "MNT6753": (jax_mnt6753, mnt6753)}


def _terms(cs):
    return [(c.a.terms, c.b.terms, c.c.terms, c.is_square) for c in cs.constraints]


def _same(got, want):
    gc, wc = got.constraint_system, want.constraint_system
    assert (gc.p, gc.primary_input_size, gc.auxiliary_input_size) == (
        wc.p, wc.primary_input_size, wc.auxiliary_input_size)
    assert _terms(gc) == _terms(wc)
    assert (got.primary_input, got.auxiliary_input) == (want.primary_input, want.auxiliary_input)


def _pair(kind, num_constraints, num_inputs, seed):
    fn = f"generate_r1cs_example_with_{kind}_input"
    rj, rt = random.Random(seed), random.Random(seed)
    want = getattr(jax_examples, fn)(P, num_constraints, num_inputs, rj)
    got = getattr(port_examples, fn)(P, num_constraints, num_inputs, rt)
    assert rt.random() == rj.random()  # the same draws, in the same number
    return got, want


@pytest.mark.parametrize("kind,num_constraints,num_inputs", [
    ("field", 1, 1), ("field", 6, 1), ("field", 11, 2), ("field", 30, 5),
    ("binary", 1, 1), ("binary", 9, 3), ("binary", 25, 4)])
def test_examples_match_jax(kind, num_constraints, num_inputs):
    got, want = _pair(kind, num_constraints, num_inputs, num_constraints * 7 + num_inputs)
    _same(got, want)
    cs = got.constraint_system
    assert cs.is_valid() and cs.is_satisfied(got.primary_input, got.auxiliary_input)
    bad = list(got.auxiliary_input)
    bad[-1] = (bad[-1] + 1) % P
    assert not cs.is_satisfied(got.primary_input, bad)
    assert not want.constraint_system.is_satisfied(want.primary_input, bad)
    swapped = cs.swap_AB_if_beneficial()
    assert swapped == want.constraint_system.swap_AB_if_beneficial()
    assert _terms(cs) == _terms(want.constraint_system)


def test_field_example_closing_constraint():
    """The closing constraint is (x_1 + ... + x_{m-1})^2 = x_m, built in one
    pass, A and B separate lists with the JAX package's order."""
    got, _ = _pair("field", 9, 1, 3)
    cs = got.constraint_system
    last = cs.constraints[-1]
    assert last.a.terms == last.b.terms == [(i, 1) for i in range(1, cs.num_variables)]
    assert last.a.terms is not last.b.terms
    assert last.c.terms == [(cs.num_variables, 1)]


def test_examples_refuse_bad_sizes():
    with pytest.raises(ValueError):
        port_examples.generate_r1cs_example_with_field_input(P, 1, 4, random.Random(0))
    with pytest.raises(ValueError):
        port_examples.generate_r1cs_example_with_binary_input(P, 3, 0, random.Random(0))


# (curve, constraints of the field example): the domain sizes n_c + 2
# are 8 (radix-2), 12 (step, MNT4753) and 10 (mixed radix, MNT6753)
QAP_CASES = [("MNT4753", 6), ("MNT4753", 10), ("MNT6753", 6), ("MNT6753", 8), ("MNT6753", 22)]


@pytest.mark.parametrize("curve,num_constraints", QAP_CASES)
def test_instance_map_and_abc_match_jax(curve, num_constraints):
    jmod, tmod = MODELS[curve]
    Fj, Ft = jmod.get().Fr, tmod.get("cpu").Fr
    rng = random.Random(num_constraints)
    got, want = _pair_over(Ft.p, num_constraints)
    assert (got.constraint_system.swap_AB_if_beneficial()
            == want.constraint_system.swap_AB_if_beneficial())
    for t in (rng.randrange(1, Ft.p), 1):  # 1 is a point of every domain
        gi = port_qap.instance_map_with_evaluation(got.constraint_system, t, Ft)
        wi = jax_qap.instance_map_with_evaluation(want.constraint_system, t, Fj)
        assert vars(gi) == {k: v for k, v in vars(wi).items() if k != "Ht"}
        # the JAX package's powers of t are the port's power_table, made where used
        powers = words_to_ints(Ft.to_canonical(power_table(Ft, t, gi.domain_size + 1)).numpy())
        assert powers == wi.Ht
    assert port_qap.qap_domain_size(got.constraint_system, Ft) == jax_qap.qap_domain_size(
        want.constraint_system, Fj) == gi.domain_size
    g = port_qap.assemble_abc_evaluations(got.constraint_system, got.primary_input,
                                          got.auxiliary_input, Ft)
    w = jax_qap.assemble_abc_evaluations(want.constraint_system, want.primary_input,
                                         want.auxiliary_input, Fj)
    assert g == w and len(g[0]) == gi.domain_size


def _pair_over(p, num_constraints):
    rj, rt = random.Random(num_constraints), random.Random(num_constraints)
    want = jax_examples.generate_r1cs_example_with_field_input(p, num_constraints, 1, rj)
    got = port_examples.generate_r1cs_example_with_field_input(p, num_constraints, 1, rt)
    _same(got, want)
    return got, want
