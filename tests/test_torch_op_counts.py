"""The port's run-time op counts (``utils/op_counts.py``) against the JAX
package's trace-time counts:

  * one addition and one doubling on each of the four curve groups report
    what the JAX trace (``jax.jit(...).lower`` under ``counting()``, as
    tests/test_op_counts.py runs it) reports, less the products where the
    two schedules differ, each of those traced by the JAX package itself:
    the JAX formulas multiply by a (three times in an addition, once in a
    doubling) and by 3b (twice in an addition) as full products over the
    coordinate field and square w with ``sqr``; the port's, those of its
    kernels, multiply by a as a small-integer scaling (no field operation),
    by 3b as a monomial (``cuda_group._mul_b3``: one base product a
    component) and make w^2 one of its stacked products (a ``mul``);
  * the kernel path's figures (``cuda_group.formula_ops``) are those the
    plain version records;
  * ``pow_int`` counts what it runs: it squares and multiplies only from the
    bit after the leading one, so 13 = 0b1101 gives 3 ``sqr`` and 2 ``mul``
    an element where the JAX trace counts 4 and 4 (masked);
  * the MSM's ``{G}.dbl`` is its windows times c;
  * with no ``counting()`` scope active nothing is recorded.

Every comparison is exact."""

import collections

import jax
import jax.numpy as jnp
import pytest
import torch

from snark_challenge_prover_tpu.models import mnt4753 as jax_mnt4753
from snark_challenge_prover_tpu.models import mnt6753 as jax_mnt6753
from snark_challenge_prover_tpu.utils import op_counts as jax_op_counts
from snark_challenge_prover_tpu_torch.models import mnt4753, mnt6753
from snark_challenge_prover_tpu_torch.ops import cuda_group, msm
from snark_challenge_prover_tpu_torch.ops.field import canonical_words
from snark_challenge_prover_tpu_torch.utils import op_counts

torch.set_num_threads(1)

MODELS = {"MNT4753": (jax_mnt4753, mnt4753), "MNT6753": (jax_mnt6753, mnt6753)}
GROUPS = [(c, g) for c in MODELS for g in ("G1", "G2")]
BATCH = 5


def models(curve):
    jm, pm = MODELS[curve]
    return jm.get(), pm.get("cpu")


def jax_count(fn, *args) -> collections.Counter:
    with jax_op_counts.counting() as c:
        jax.jit(fn).lower(*args)
    return collections.Counter(c.counts)


def port_count(fn, *args) -> collections.Counter:
    with op_counts.counting() as c:
        fn(*args)
    return collections.Counter(c.counts)


def combine(*terms) -> dict:
    """sum of k * counter over (k, counter) terms, zero entries dropped."""
    out = collections.Counter()
    for k, c in terms:
        for key, v in c.items():
            out[key] += k * v
    return {key: v for key, v in out.items() if v}


@pytest.mark.parametrize("curve,group", GROUPS)
@pytest.mark.parametrize("op", ["add", "dbl"])
def test_group_op_counts_match_jax_trace(curve, group, op):
    J, P = models(curve)
    JG, PG = getattr(J, group), getattr(P, group)
    jx, px = JG.F.ones((BATCH,)), PG.F.ones((BATCH,))
    jp, pp = (jx, jx, jx), (px, px, px)
    # a product as the JAX formulas make it: the constant broadcast over the
    # batch (``_mulsb``), so its side of a Karatsuba sum counts a point too
    const_prod = lambda c: jax_count(lambda x: JG.F.mul(jnp.broadcast_to(c(x), x.shape), x), jx)
    a_prod = const_prod(JG._a_const)
    if op == "add":
        jax_rep = jax_count(JG.add, jp, jp)
        port_rep = port_count(PG.add, pp, pp)
        b3_prod = const_prod(JG._b3_const)
        port_b3 = port_count(lambda x: cuda_group._mul_b3(PG, PG.F, [x]), px)
        want = combine((1, jax_rep), (-3, a_prod), (-2, b3_prod), (2, port_b3))
    else:
        jax_rep = jax_count(JG.double, jp)
        port_rep = port_count(PG.double, pp)
        want = combine((1, jax_rep), (-1, a_prod), (-1, jax_count(JG.F.sqr, jx)),
                       (1, port_count(lambda x: PG.F.mul(x, x), px)))
    assert dict(port_rep) == want
    assert port_rep[f"{PG.name}.{op}"] == jax_rep[f"{JG.name}.{op}"] == BATCH


@pytest.mark.parametrize("curve,group", GROUPS)
def test_kernel_figures_are_the_plain_versions(curve, group):
    """What a kernel launch records (``formula_ops`` a point, k times for k
    doublings) is what the plain version records through ``Fp``."""
    G = getattr(models(curve)[1], group)
    x = G.F.ones((BATCH,))
    P = (x, x, x)
    for op, run, k in (("add", lambda: cuda_group.ec_add_plain(G, P, P), 1),
                       ("dbl", lambda: cuda_group.ec_dbl_plain(G, P, 3), 3)):
        figures = cuda_group.formula_ops(G, op)
        assert f"{G.name}.{op}" not in figures and figures
        want = combine((BATCH * k, collections.Counter(figures)),
                       (BATCH * k, collections.Counter({f"{G.name}.{op}": 1})))
        assert dict(port_count(run)) == want


def test_pow_int_counts_what_it_runs():
    F = models("MNT4753")[1].Fq
    rep = port_count(lambda a: F.pow_int(a, 13), F.ones((3,)))
    # 13 = 0b1101: squarings for the three bits after the leading one, a
    # multiply for each set one among them; the JAX trace counts 4 and 4
    assert rep == {f"{F.name}.sqr": 3 * 3, f"{F.name}.mul": 2 * 3}
    rep = port_count(F.inv, F.ones((2,)))
    e = F.p - 2
    assert rep == {f"{F.name}.inv": 2, f"{F.name}.sqr": 2 * (e.bit_length() - 1),
                   f"{F.name}.mul": 2 * (bin(e).count("1") - 1)}


def test_msm_doublings_are_windows_times_c():
    P = models("MNT4753")[1]
    G, n, c, bits = P.G1, 4, 4, 16
    x = P.Fq.ones((n,))
    scalars = canonical_words(P.Fr, [3, 5, 7, 11])
    windows = bits // c
    rep = port_count(lambda: msm.msm_staged(G, (x, x, x), scalars, c, windows, bits))
    assert rep[f"{G.name}.dbl"] == windows * c
    assert rep[f"{G.name}.add"] > 0


def test_nothing_is_recorded_without_a_scope(monkeypatch):
    P = models("MNT6753")[1]
    assert op_counts.active() is None

    def refuse(*args):
        raise AssertionError("recorded outside a counting() scope")

    monkeypatch.setattr(op_counts.OpCounter, "add", refuse)
    x = P.Fq.ones((2,))
    P.Fq.inv(P.Fq.sub(P.Fq.add(x, x), x))
    P.G1.double(P.G1.add((x, x, x), (x, x, x)), 2)
    y = P.Fq3.ones((2,))
    P.G2.add((y, y, y), (y, y, y))
    monkeypatch.undo()
    with op_counts.counting() as c:
        assert op_counts.active() is c and not c.counts
        with op_counts.counting() as inner:
            P.Fq.mul(x, x)
        P.Fq.sqr(x)
    assert op_counts.active() is None
    assert inner.report() == {"MNT6753.Fq.mul": 2}
    assert c.report() == {"MNT6753.Fq.sqr": 2}
