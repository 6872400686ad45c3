"""The port's basic, field-extension and curve gadgets against the JAX
package's: on the cases of the JAX package's tests/test_gadgets.py,
test_field_ext_gadgets.py and test_curve_gadgets.py (tampering included),
each built once with each package's modules, the protoboards hold equal
constraint systems term for term (with their annotations), equal
witnesses and equal verdicts.  Then the port's reduced Tate pairing
(``proof_systems/pairing.py``) against the JAX package's on seeded pairs,
and its bilinearity.  Points come from the port's host curves, shared by
both sides."""

import random
from types import SimpleNamespace

import pytest

import snark_challenge_prover_tpu.gadgets.basic_gadgets as jax_basic
import snark_challenge_prover_tpu.gadgets.curve_gadgets as jax_curve
import snark_challenge_prover_tpu.gadgets.field_ext_gadgets as jax_ext
import snark_challenge_prover_tpu.gadgets.protoboard as jax_pb
import snark_challenge_prover_tpu.host.curves as jax_host
import snark_challenge_prover_tpu.proof_systems.ate_pairing as jax_ate
import snark_challenge_prover_tpu.proof_systems.pairing as jax_tate
import snark_challenge_prover_tpu_torch.gadgets.basic_gadgets as basic
import snark_challenge_prover_tpu_torch.gadgets.curve_gadgets as curve
import snark_challenge_prover_tpu_torch.gadgets.field_ext_gadgets as ext
import snark_challenge_prover_tpu_torch.gadgets.protoboard as pbm
import snark_challenge_prover_tpu_torch.host.curves as host
import snark_challenge_prover_tpu_torch.proof_systems.ate_pairing as ate
import snark_challenge_prover_tpu_torch.proof_systems.pairing as tate
from tools.oracle import mnt4753_oracle, mnt6753_oracle

PACKAGES = {
    "jax": SimpleNamespace(pb=jax_pb, basic=jax_basic, ext=jax_ext, curve=jax_curve,
                           host=jax_host, ate=jax_ate),
    "port": SimpleNamespace(pb=pbm, basic=basic, ext=ext, curve=curve, host=host, ate=ate),
}
HC = {name: host.host_curve(name) for name in ("MNT4753", "MNT6753")}
P4 = HC["MNT6753"].fq_spec.p  # MNT4753's Fr (= MNT6753's Fq), the JAX tests' field
Q4, Q6 = HC["MNT4753"].fq_spec.p, HC["MNT6753"].fq_spec.p  # the towers' base fields


def snapshot(pb) -> tuple:
    """A protoboard's whole state: modulus, inputs, every constraint's terms
    and annotation, the assignment."""
    cons = [(tuple(c.a.terms), tuple(c.b.terms), tuple(c.c.terms), c.is_square)
            for c in pb.constraints]
    return pb.p, pb._num_inputs, cons, list(pb.annotations), list(pb._values)


# --------------------------------------------------------------------------
# the cases, each written once over a package's modules (``ns``); each
# returns (the protoboards' snapshots, the verdicts and values it observed)
# --------------------------------------------------------------------------
def case_packing(ns):
    out = []
    pb = ns.pb.Protoboard(P4)
    packed = pb.allocate_var("packed")
    bits = ns.pb.PBVariableArray.allocate(pb, 8, "bits")
    g = ns.basic.PackingGadget(pb, bits, packed)
    g.generate_r1cs_constraints()
    pb.set_val(packed, 0b10110101)
    g.generate_r1cs_witness_from_packed()
    out += [pb.is_satisfied(), [pb.val(b) for b in bits]]
    snaps = [snapshot(pb)]
    pb.set_val(bits[0], 0)
    out.append(pb.is_satisfied())
    rng = random.Random(3)
    pb = ns.pb.Protoboard(P4)
    packed = pb.allocate_var()
    bits = ns.pb.PBVariableArray.allocate(pb, 5, "bits")
    g = ns.basic.PackingGadget(pb, bits, packed)
    g.generate_r1cs_constraints()
    for b in bits:
        pb.set_val(b, rng.randrange(2))
    g.generate_r1cs_witness_from_bits()
    out.append(pb.is_satisfied())
    return snaps + [snapshot(pb)], out


def case_boolean(ns):
    pb = ns.pb.Protoboard(P4)
    x = pb.allocate_var()
    ns.basic.generate_boolean_r1cs_constraint(pb, x)
    pb.set_val(x, 1)
    out = [pb.is_satisfied()]
    pb.set_val(x, 2)
    return [snapshot(pb)], out + [pb.is_satisfied()]


def case_inner_product(ns):
    rng = random.Random(4)
    pb = ns.pb.Protoboard(P4)
    A = ns.pb.PBVariableArray.allocate(pb, 5, "A")
    B = ns.pb.PBVariableArray.allocate(pb, 5, "B")
    res = pb.allocate_var("res")
    g = ns.basic.InnerProductGadget(pb, A, B, res)
    g.generate_r1cs_constraints()
    for v in list(A) + list(B):
        pb.set_val(v, rng.randrange(P4))
    g.generate_r1cs_witness()
    return [snapshot(pb)], [pb.is_satisfied(), pb.val(res)]


def case_or_and(ns):
    rng = random.Random(5)
    snaps, out = [], []
    for cls in (ns.basic.DisjunctionGadget, ns.basic.ConjunctionGadget):
        for trial in range(4):
            pb = ns.pb.Protoboard(P4)
            ins = ns.pb.PBVariableArray.allocate(pb, 4, "in")
            res = pb.allocate_var("out")
            g = cls(pb, ins, res)
            g.generate_r1cs_constraints()
            bits = [[0] * 4, [1] * 4][trial] if trial < 2 else [rng.randrange(2) for _ in range(4)]
            for v, x in zip(ins, bits):
                pb.set_val(v, x)
            g.generate_r1cs_witness()
            snaps.append(snapshot(pb))
            out.append((bits, pb.is_satisfied(), pb.val(res)))
    return snaps, out


def case_comparison(ns):
    snaps, out = [], []
    for a, b in [(3, 7), (7, 3), (5, 5), (0, 15), (15, 15)]:
        pb = ns.pb.Protoboard(P4)
        A, B = pb.allocate_var("A"), pb.allocate_var("B")
        less, leq = pb.allocate_var("less"), pb.allocate_var("leq")
        g = ns.basic.ComparisonGadget(pb, 4, A, B, less, leq)
        g.generate_r1cs_constraints()
        pb.set_val(A, a)
        pb.set_val(B, b)
        g.generate_r1cs_witness()
        snaps.append(snapshot(pb))
        out.append((pb.is_satisfied(), pb.val(less), pb.val(leq)))
    return snaps, out


def case_multiplication_to_cs(ns):
    pb = ns.pb.Protoboard(P4)
    x, y, z = pb.allocate_var("x"), pb.allocate_var("y"), pb.allocate_var("z")
    g = ns.basic.MultiplicationGadget(pb, x, y, z)
    g.generate_r1cs_constraints()
    pb.set_input_sizes(1)
    pb.set_val(x, 6)
    pb.set_val(y, 7)
    g.generate_r1cs_witness()
    cs = pb.get_constraint_system()
    return [snapshot(pb)], [cs.is_satisfied(pb.primary_input(), pb.auxiliary_input()),
                            pb.val(z), cs.primary_input_size, cs.auxiliary_input_size]


def _alloc_set(ns, pb, deg, vals):
    x = ns.ext.ExtVariable.allocate(pb, deg)
    x.set(pb, vals)
    return x


def case_ext_mul_sqr(ns):
    """Fp2 mul (with a tampered output) and sqr over MNT4753's Fq, Fp3 mul
    over MNT6753's."""
    rng = random.Random(5)
    snaps, out = [], []
    for kind, p, deg, nr in (("mul2", Q4, 2, 13), ("sqr2", Q4, 2, 13), ("mul3", Q6, 3, 11)):
        pb = ns.pb.Protoboard(p)
        a = _alloc_set(ns, pb, deg, tuple(rng.randrange(p) for _ in range(deg)))
        res = ns.ext.ExtVariable.allocate(pb, deg)
        if kind == "sqr2":
            g = ns.ext.Fp2SqrGadget(pb, nr, a, res)
        else:
            b = _alloc_set(ns, pb, deg, tuple(rng.randrange(p) for _ in range(deg)))
            g = (ns.ext.Fp2MulGadget if deg == 2 else ns.ext.Fp3MulGadget)(pb, nr, a, b, res)
        g.generate_r1cs_constraints()
        g.generate_r1cs_witness()
        snaps.append(snapshot(pb))
        out.append((kind, pb.is_satisfied(), res.values(pb), pb.num_constraints))
        if kind == "mul2":
            (idx, _), = res.comps[0].terms
            pb.set_val(ns.pb.PBVariable(idx), (pb.lc_val(res.comps[0]) + 1) % p)
            out.append(pb.is_satisfied())
    return snaps, out


def case_tower2_mul(ns):
    rng = random.Random(8)
    snaps, out = [], []
    for p, deg, nr in ((Q4, 2, 13), (Q6, 3, 11)):
        pb = ns.pb.Protoboard(p)
        vals = [tuple(tuple(rng.randrange(p) for _ in range(deg)) for _ in range(2))
                for _ in range(2)]
        a, b = (ns.ext.Tower2Variable.allocate(pb, deg) for _ in range(2))
        a.set(pb, vals[0])
        b.set(pb, vals[1])
        res = ns.ext.Tower2Variable.allocate(pb, deg)
        g = ns.ext.Tower2MulGadget(pb, deg, nr, a, b, res)
        g.generate_r1cs_constraints()
        g.generate_r1cs_witness()
        snaps.append(snapshot(pb))
        out.append((pb.is_satisfied(), vals, res.values(pb)))
    return snaps, out


def case_ext_inverse(ns):
    rng = random.Random(9)
    snaps, out = [], []
    for deg, p, nr in ((2, Q4, 13), (3, Q6, 11)):
        pb = ns.pb.Protoboard(p)
        av = tuple(rng.randrange(1, p) for _ in range(deg))
        a = _alloc_set(ns, pb, deg, av)
        inv = ns.ext.ExtVariable.allocate(pb, deg)
        g = ns.ext.ExtInvGadget(pb, deg, nr, a, inv)
        g.generate_r1cs_constraints()
        g.generate_r1cs_witness()
        snaps.append(snapshot(pb))
        out.append((pb.is_satisfied(), av, inv.values(pb)))
    return snaps, out


def case_g1_add_double_check(ns):
    hc = HC["MNT4753"]
    P, Q = hc.g1.mul(7, hc.g1_gen), hc.g1.mul(11, hc.g1_gen)
    snaps, out = [], []
    pb = ns.pb.Protoboard(Q4)
    v = {n: pb.allocate_var(n) for n in ("x1", "y1", "x2", "y2", "x3", "y3")}
    for n, val in zip(("x1", "y1", "x2", "y2"), (*P, *Q)):
        pb.set_val(v[n], val)
    g = ns.curve.G1AddGadget(pb, (v["x1"], v["y1"]), (v["x2"], v["y2"]), (v["x3"], v["y3"]))
    g.generate_r1cs_constraints()
    g.generate_r1cs_witness()
    snaps.append(snapshot(pb))
    out.append((pb.is_satisfied(), (pb.val(v["x3"]), pb.val(v["y3"])), pb.num_constraints))
    pb.set_val(v["y3"], (pb.val(v["y3"]) + 1) % pb.p)
    out.append(pb.is_satisfied())

    pb = ns.pb.Protoboard(Q4)
    x1, y1, x3, y3 = (pb.allocate_var() for _ in range(4))
    pb.set_val(x1, P[0])
    pb.set_val(y1, P[1])
    g = ns.curve.G1DoubleGadget(pb, hc.g1.a, (x1, y1), (x3, y3))
    g.generate_r1cs_constraints()
    g.generate_r1cs_witness()
    snaps.append(snapshot(pb))
    out.append((pb.is_satisfied(), (pb.val(x3), pb.val(y3)), pb.num_constraints))

    pb = ns.pb.Protoboard(Q4)
    x, y = pb.allocate_var(), pb.allocate_var()
    pb.set_val(x, Q[0])
    pb.set_val(y, Q[1])
    g = ns.curve.G1CheckerGadget(pb, hc.g1.a, hc.g1.b, (x, y))
    g.generate_r1cs_constraints()
    g.generate_r1cs_witness()
    out.append((pb.is_satisfied(), pb.num_constraints))
    pb.set_val(y, (Q[1] + 1) % pb.p)
    g.generate_r1cs_witness()
    snaps.append(snapshot(pb))
    out.append(pb.is_satisfied())
    return snaps, out


def case_g2_add_check(ns):
    snaps, out = [], []
    for name, deg, nr in (("MNT4753", 2, 13), ("MNT6753", 3, 11)):
        hc = HC[name]
        P, Q, S = (hc.g2.mul(k, hc.g2_gen) for k in (3, 8, 6))
        pb = ns.pb.Protoboard(hc.g2.F.p)

        def mk(pt):
            x, y = ns.ext.ExtVariable.allocate(pb, deg), ns.ext.ExtVariable.allocate(pb, deg)
            x.set(pb, pt[0])
            y.set(pb, pt[1])
            return (x, y)

        p1, p2 = mk(P), mk(Q)
        res = (ns.ext.ExtVariable.allocate(pb, deg), ns.ext.ExtVariable.allocate(pb, deg))
        g = ns.curve.G2AddGadget(pb, deg, nr, p1, p2, res)
        g.generate_r1cs_constraints()
        g.generate_r1cs_witness()
        snaps.append(snapshot(pb))
        out.append((pb.is_satisfied(), (res[0].values(pb), res[1].values(pb))))

        pb = ns.pb.Protoboard(hc.g2.F.p)
        x, y = mk(S)
        g = ns.curve.G2CheckerGadget(pb, deg, nr, hc.g2.F.components(hc.g2.a),
                                     hc.g2.F.components(hc.g2.b), (x, y))
        g.generate_r1cs_constraints()
        g.generate_r1cs_witness()
        out.append(pb.is_satisfied())
        y.set(pb, tuple((c + 1) % pb.p for c in S[1]))
        g.generate_r1cs_witness()
        snaps.append(snapshot(pb))
        out.append(pb.is_satisfied())
    return snaps, out


CASES = {f.__name__[5:]: f for f in (
    case_packing, case_boolean, case_inner_product, case_or_and, case_comparison,
    case_multiplication_to_cs, case_ext_mul_sqr, case_tower2_mul, case_ext_inverse,
    case_g1_add_double_check, case_g2_add_check)}

# what the JAX package's tests assert of each case, checked on the port's run
EXPECTED = {
    "packing": lambda o: o == [True, [1, 0, 1, 0, 1, 1, 0, 1], False, True],
    "boolean": lambda o: o == [True, False],
    "inner_product": lambda o: o[0],
    "or_and": lambda o: all(sat and val == (any(b) if i < 4 else all(b))
                            for i, (b, sat, val) in enumerate(o)),
    "comparison": lambda o: o == [(True, int(a < b), int(a <= b))
                                  for a, b in [(3, 7), (7, 3), (5, 5), (0, 15), (15, 15)]],
    "multiplication_to_cs": lambda o: o == [True, 42, 1, 2],
    "ext_mul_sqr": lambda o: ([x[1] for x in o if isinstance(x, tuple)] == [True] * 3
                              and o[1] is False
                              and [x[3] for x in o if isinstance(x, tuple)] == [5, 4, 9]),
    "tower2_mul": lambda o: all(x[0] for x in o),
    "ext_inverse": lambda o: all(x[0] for x in o),
    "g1_add_double_check": lambda o: (o[0][0] and o[0][2] == 3 and o[1] is False
                                      and o[2][0] and o[2][2] == 4 and o[3] == (True, 3)
                                      and o[4] is False),
    "g2_add_check": lambda o: o == [(True, o[0][1]), True, False, (True, o[3][1]), True, False],
}


@pytest.mark.parametrize("case", list(CASES))
def test_gadget_equals_jax_term_for_term(case):
    jax_snaps, jax_out = CASES[case](PACKAGES["jax"])
    snaps, out = CASES[case](PACKAGES["port"])
    assert len(snaps) == len(jax_snaps)
    for got, want in zip(snaps, jax_snaps):
        assert got == want
    assert out == jax_out
    assert EXPECTED[case](out)


def test_gadget_values_equal_host_arithmetic():
    """The values the port's gadgets computed are the host's exact ones."""
    port = PACKAGES["port"]
    hc4, hc6 = HC["MNT4753"], HC["MNT6753"]
    _, o = case_g1_add_double_check(port)
    P, Q = hc4.g1.mul(7, hc4.g1_gen), hc4.g1.mul(11, hc4.g1_gen)
    assert o[0][1] == hc4.g1.add(P, Q) and o[2][1] == hc4.g1.add(P, P)
    _, o = case_g2_add_check(port)
    for hc, got in ((hc4, o[0][1]), (hc6, o[3][1])):
        assert got == hc.g2.add(hc.g2.mul(3, hc.g2_gen), hc.g2.mul(8, hc.g2_gen))
    _, o = case_ext_inverse(port)
    for (_, a, inv), hc in zip(o, (hc4, hc6)):
        assert hc.g2.F.mul(a, inv) == hc.g2.F.one
    _, o = case_tower2_mul(port)
    for (_, (a, b), got), hc in zip(o, (hc4, hc6)):
        assert got == ate.HostGT(hc.g2.F).mul(a, b)


# --------------------------------------------------------------------------
# the reduced Tate pairing (proof_systems/pairing.py)
# --------------------------------------------------------------------------
ORACLES = {"MNT4753": mnt4753_oracle, "MNT6753": mnt6753_oracle}


@pytest.fixture(scope="module", params=list(HC))
def tate_pair(request):
    name = request.param
    hc = HC[name]
    rng = random.Random(len(name))
    a, b = rng.getrandbits(32) | 1, rng.getrandbits(32) | 1
    P, Q = hc.g1.mul(a, hc.g1_gen), hc.g2.mul(b, hc.g2_gen)
    port = tate.PairingEngine(hc)
    return name, hc, P, Q, port, port.reduced_pairing(P, Q)


def test_tate_equals_jax_engine(tate_pair):
    name, hc, P, Q, port, value = tate_pair
    assert value == jax_tate.PairingEngine(ORACLES[name]()).reduced_pairing(P, Q)
    assert port.reduced_pairing(None, Q) == port.gt.one
    assert value != port.gt.one


def test_tate_is_bilinear(tate_pair):
    """e(2P, 3Q) = e(P, Q)^6 = e(6P, Q), and e(-P, Q) e(P, Q) = 1."""
    name, hc, P, Q, port, value = tate_pair
    six = port.gt.pow(value, 6)
    assert port.reduced_pairing(hc.g1.mul(2, P), hc.g2.mul(3, Q)) == six
    assert port.reduced_pairing(hc.g1.mul(6, P), Q) == six
    assert port.gt.mul(port.reduced_pairing(hc.g1.neg(P), Q), value) == port.gt.one
