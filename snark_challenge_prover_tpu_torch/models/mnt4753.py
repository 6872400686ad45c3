"""MNT4753 curve model: fields and groups on one device.

Constants from depends/libff/libff/algebra/curves/mnt753/mnt4753/
mnt4753_init.cpp (public curve parameters): Fr s=30 (line 65), Fq s=15
(line 91), G1 a=2/b=... (lines 119-120), Fq2 non-residue 13 (line 105),
twist (0, 1) with a' = a*nr, b' = b*nr u (lines 121-126).
"""

from __future__ import annotations

import torch

from ..ops.cuda_group import AddKernel, DblKernel
from ..ops.field import Fp, resolve_device
from ..ops.frobenius import mnt4753_twist_mul_by_q
from ..ops.group import Curve
from ..ops.towers import Fp2, Fp4
from .primes import FIELD_A, FIELD_B

# G1 generator affine coordinates (mnt4753_init.cpp:140-142)
G1_ONE_X = int(
    "2380350383848269736421921239610031425526628225628775853221046095867071128450137425490924908464354910466887899622419389706197678805218566256973877402875644666240095481767694733709068625713487470322413318306121421321686601944"
    "4443"
)
G1_ONE_Y = int(
    "2109101215293822581305054066528029192903292433351847627911071114867046479481854482052239029520971553190124867688854406059094373724956373310480669796877979661037499449870269884016953872516495607272694250066513292794203707813"
    "5054"
)

# G2 generator affine coordinates over Fq2 (mnt4753_init.cpp:201-203)
G2_ONE_X0 = int(
    "2236766662332108072006025684467936984145084925863448512222682666868700892855724116238905258729493910598779158980719870107208985018420306062903609002720688454739781908002692641225697813553673565604917305957312082210565415"
    "3939204"
)
G2_ONE_X1 = int(
    "1967434935406558266356988639055710521537576435646401391080413653483188091574216194571126787102391813694147200375107570386094320502664884706424708012467079919099839523469418262179458016057682216722818744385123397204952145"
    "5293042"
)
G2_ONE_Y0 = int(
    "6945425020677398967988875731588951175743495235863391886533295045397037605326535330657361771765903175481062759367498970743022872494546449436815843306838794729313050998681159000579427733029709987073254733976366326071957733"
    "646574"
)
G2_ONE_Y1 = int(
    "1740610077548935273867848515402703619161828316367998019519367789678527317250646621623202603778878843644218805788982001427637877293604263871771038498723943091236468104607062520047493197526687599528205549980323681301387478"
    "8622488"
)

G1_COEFF_A = 2
G1_COEFF_B = int(
    "2879880390345638889141003679329940576494037236009993834075257640639388037212697006842138331248285354157278008736393844237793370686525205350707754342053438048649278662655626908325565712502596382561084022256869413713874155"
    "4679540"
)
FQ2_NON_RESIDUE = 13  # == Fq::nqr (mnt4753_init.cpp:96,105)

# the addition and doubling kernels compiled for the two groups
# (csrc/ec_add.cu, csrc/ec_dbl.cu): a = 2; on the twist a' = (a nr, 0) and
# 3b' = (0, 3b nr)
G1_ADD_KERNEL = AddKernel("ec_add_fp_mnt4753", G1_COEFF_A, 0, 0)
G2_ADD_KERNEL = AddKernel("ec_add_fp2_mnt4753", G1_COEFF_A * FQ2_NON_RESIDUE, 0, 1)
G1_DBL_KERNEL = DblKernel("ec_dbl_fp_mnt4753", G1_COEFF_A, 0)
G2_DBL_KERNEL = DblKernel("ec_dbl_fp2_mnt4753", G1_COEFF_A * FQ2_NON_RESIDUE, 0)


class MNT4753:
    """Field and group objects of MNT4753, all on ``device``."""

    name = "MNT4753"
    g2_deg = 2

    def __init__(self, device):
        self.device = resolve_device(device)
        self.Fr = Fp(FIELD_A, self.device, "MNT4753.Fr")
        self.Fq = Fp(FIELD_B, self.device, "MNT4753.Fq")
        self.Fq2 = Fp2(self.Fq, FQ2_NON_RESIDUE, "MNT4753.Fq2")
        # GT = Fq4 (the ate pairing's target, fp4.tcc)
        self.Fq4 = Fp4(self.Fq2, FQ2_NON_RESIDUE, "MNT4753.Fq4")
        self.GT = self.Fq4
        q = self.Fq.p
        self.G1 = Curve(self.Fq, self.Fq.const(G1_COEFF_A), self.Fq.const(G1_COEFF_B),
                        self.device, "MNT4753.G1", G1_ADD_KERNEL, G1_DBL_KERNEL)
        # twist coefficients: a2 = (a*nr, 0), b2 = (0, b*nr) (mnt4753_init.cpp:122-126)
        zero = self.Fq.const(0)
        a2 = torch.stack([self.Fq.const(G1_COEFF_A * FQ2_NON_RESIDUE % q), zero])
        b2 = torch.stack([zero, self.Fq.const(G1_COEFF_B * FQ2_NON_RESIDUE % q)])
        self.G2 = Curve(self.Fq2, a2, b2, self.device, "MNT4753.G2", G2_ADD_KERNEL,
                        G2_DBL_KERNEL)

    def g1_generator(self):
        """The G1 generator, projective with Z = 1 and batch () (Montgomery form)."""
        Fq = self.Fq
        return (Fq.const(G1_ONE_X), Fq.const(G1_ONE_Y), Fq.const(1))

    def g2_generator(self):
        """The G2 generator, projective with Z = 1 and batch ()."""
        Fq = self.Fq
        return (torch.stack([Fq.const(c) for c in (G2_ONE_X0, G2_ONE_X1)]),
                torch.stack([Fq.const(c) for c in (G2_ONE_Y0, G2_ONE_Y1)]),
                torch.stack([Fq.const(1)] + [Fq.const(0)] * 1))

    def g2_mul_by_q(self, P):
        """The Frobenius endomorphism on G2 (mnt4753_g2.cpp:364-369,
        mnt4753_init.cpp:131-132): (tx X^q, ty Y^q, Z^q) for a projective
        batch P, the twist multipliers from ops.frobenius."""
        tx, ty = mnt4753_twist_mul_by_q()
        E, Fq = self.Fq2, self.Fq
        X, Y, Z = P
        return (E.scale_prime_const(E.frobenius_map(X, 1), Fq.const(tx)),
                E.scale_prime_const(E.frobenius_map(Y, 1), Fq.const(ty)),
                E.frobenius_map(Z, 1))


def get(device="cuda") -> MNT4753:
    """The model on ``device``: the GPU unless the caller asks for the CPU."""
    return MNT4753(device)
