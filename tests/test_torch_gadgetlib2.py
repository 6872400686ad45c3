"""The port's gadgetlib2-style DSL and adapter (``gadgets/gadgetlib2.py``)
against the JAX package's: the four cases of the JAX package's
tests/test_gadgetlib2.py run on both packages; the adapter's converted
systems (every constraint's terms, the input sizes and the assignment) are
equal; and the port's converted system is proved and verified by the
port's ``groth16_full`` on the CPU (about 90 s: a key generation and a
prove in plain PyTorch).  Variable ids come from each module's own counter,
so they differ between the packages; what the adapter converts does not."""

import random

import pytest
import torch

from snark_challenge_prover_tpu.gadgets import gadgetlib2 as jax_gl2
from snark_challenge_prover_tpu_torch.gadgets import gadgetlib2 as gl2
from snark_challenge_prover_tpu_torch.models import mnt4753
from snark_challenge_prover_tpu_torch.proof_systems import groth16_full as g16

torch.set_num_threads(1)

P = mnt4753.get("cpu").Fr.p
PACKAGES = {"jax": jax_gl2, "port": gl2}


def product_circuit(mod):
    pb = mod.Protoboard(P)
    x, a, b = mod.Variable("x"), mod.Variable("a"), mod.Variable("b")
    pb.setVal(x, 35)
    pb.setVal(a, 5)
    pb.setVal(b, 7)
    pb.setPublicAmount(1)
    pb.addRank1Constraint(a, b, x, "a*b=x")
    pb.enforceBooleanity(mod.Variable("bit"))  # unset -> 0, boolean ok
    return pb, x, a, b


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_satisfaction_and_val(pkg):
    pb, x, a, b = product_circuit(PACKAGES[pkg])
    assert pb.isSatisfied()
    assert pb.val(a + b) == 12
    assert pb.val(2 * a - b) == 3
    pb.setVal(x, 36)
    assert not pb.isSatisfied()


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_unary_constraint(pkg):
    mod = PACKAGES[pkg]
    pb = mod.Protoboard(P)
    v = mod.Variable()
    pb.setVal(v, 4)
    pb.addUnaryConstraint(mod.LinearCombination(v) - 4, "v == 4")
    assert pb.isSatisfied()
    pb.setVal(v, 5)
    assert not pb.isSatisfied()


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_adapter_roundtrip(pkg):
    pb, x, a, b = product_circuit(PACKAGES[pkg])
    cs, primary, aux = PACKAGES[pkg].GadgetLibAdapter().convert(pb)
    assert cs.num_constraints == 2
    assert primary == [35]
    assert cs.is_satisfied(primary, aux)
    assert not cs.is_satisfied([36], aux)


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_adapter_feeds_proof_system(pkg):
    pb, x, a, b = product_circuit(PACKAGES[pkg])
    cs, primary, aux = PACKAGES[pkg].GadgetLibAdapter().convert(pb)
    assert cs.num_variables == len(primary) + len(aux)
    assert cs.is_valid()


def converted(mod):
    """The product circuit with a constraint over sums with constants and a
    unary one, converted: (system, primary, auxiliary)."""
    pb, x, a, b = product_circuit(mod)
    c = mod.Variable("c")
    pb.setVal(c, 12)
    pb.addRank1Constraint(a + b - 3, 2 * c - a, 14 * c + 3, "(a + b - 3)(2c - a) = 14c + 3")
    pb.addUnaryConstraint(c - a - b, "c = a + b")
    return mod.GadgetLibAdapter().convert(pb)


def test_adapter_systems_equal_jax():
    (cs_j, pr_j, aux_j), (cs, pr, aux) = converted(jax_gl2), converted(gl2)
    assert (cs.p, cs.primary_input_size, cs.auxiliary_input_size) == (
        cs_j.p, cs_j.primary_input_size, cs_j.auxiliary_input_size)
    assert [(c.a.terms, c.b.terms, c.c.terms) for c in cs.constraints] == [
        (c.a.terms, c.b.terms, c.c.terms) for c in cs_j.constraints]
    assert (pr, aux) == (pr_j, aux_j)
    assert cs.is_satisfied(pr, aux)


def test_converted_system_proves_and_verifies():
    """The port's converted system through the port's groth16_full on the
    CPU: the proof verifies on its input and not on another."""
    cs, primary, aux = converted(gl2)
    model = mnt4753.get("cpu")
    rng = random.Random(21)
    kp = g16.generator(model, cs, rng)
    proof = g16.prover(model, kp.pk, primary, aux, rng)
    assert g16.verifier_strong_IC(kp.vk, primary, proof)
    assert not g16.verifier_strong_IC(kp.vk, [36], proof)
