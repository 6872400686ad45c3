"""MNT6753 curve model: fields and groups on one device.

Constants from depends/libff/libff/algebra/curves/mnt753/mnt6753/
mnt6753_init.cpp (public curve parameters): Fr s=15 with the small
subgroup 5^2 (lines 66, 73-76), Fq s=30 (line 95), G1 a=11/b=... (lines
130-131), Fq3 non-residue 11 (line 109), twist (0, 1, 0) with
a' = (0, 0, a), b' = (b*nr, 0, 0) (lines 132-136).
"""

from __future__ import annotations

import torch

from ..ops.cuda_group import AddKernel, DblKernel
from ..ops.field import Fp, resolve_device
from ..ops.frobenius import mnt6753_twist_mul_by_q
from ..ops.group import Curve
from ..ops.towers import Fp3, Fp6_2over3
from .primes import FIELD_A, FIELD_B_SMALL

# G1 generator affine coordinates (mnt6753_init.cpp:153-155)
G1_ONE_X = int(
    "1636423638749168944475905794433417357907074747373833974909348733764473922893526815750421807812640106695481515289268854165472682942432659903852250351730246622614378898821741084267285756466552780604425000380851418427423393"
    "8437290"
)
G1_ONE_Y = int(
    "4510127914410645922431074687553594593336087066778984214797709122300210966076979927285161950203037801392624582544098750667549188549761032654706830225743998064330900301346566408501390638273322467173741629353517809979540986"
    "561128"
)

# G2 generator affine coordinates over Fq3 (mnt6753_init.cpp:213-219)
G2_ONE_X0 = int(
    "4653829723800628043404587933534938322121078948844112607364089523902383229008031012541304987815209592617601303631472085078168661426524430753645022845061534683432426747848599467071680742871851829971070267189519047566187155"
    "7310"
)
G2_ONE_X1 = int(
    "1032973993542701656456184296355188344591570142421417778291112876523027179021502918579583099958363874411936857174292996479395537593067717854487342439291088402498634805913744938953374485169108215923306544476689926277135835"
    "5816328"
)
G2_ONE_X2 = int(
    "1996281705817433469186401523206267173635375622148589603407281426189453078656859143127923035244420568236146399717593797324992973206349025681310171458619964257134437801221037432776405955781664798033473353822684369231628559"
    "1005879"
)
G2_ONE_Y0 = int(
    "5648166377754359996653513138027891970842739892107427747585228022871109585680076240624013411622970109911154113378703562803827053335040877618934773712021441101121297691389632155906182656254145368668854360318258860716497525"
    "179898"
)
G2_ONE_Y1 = int(
    "2681785035602504563047731382887580889399493526586328091820794041261716825477278957870031655106594989997193747548745853950351403492897453043200975956297598307735591205060650914790495822939838909369749417431183281361556425"
    "6810453"
)
G2_ONE_Y2 = int(
    "3233231970935857844169673158670449558179685896259470163393292735804056621078854262496374933610994033525714389929317711605003168405434895881329078139413128465716554047682421129550849884210209321980864256347760339247090921"
    "7611033"
)

G1_COEFF_A = 11
G1_COEFF_B = int(
    "1162590899954132115202734022401037471684116770178358464833890823541085926706007981972274793926792538906261106215660193816601009874792037873892783265813362545426011540907581618755505585949025337570472802794431550112272342"
    "6879114"
)
FQ3_NON_RESIDUE = 11  # == Fq::nqr (mnt6753_init.cpp:100,109)

# the addition and doubling kernels compiled for the two groups
# (csrc/ec_add.cu, csrc/ec_dbl.cu): a = 11; on the twist a' = (0, 0, a) =
# a u^2 and 3b' = (3b nr, 0, 0)
G1_ADD_KERNEL = AddKernel("ec_add_fp_mnt6753", G1_COEFF_A, 0, 0)
G2_ADD_KERNEL = AddKernel("ec_add_fp3_mnt6753", G1_COEFF_A, 2, 0)
G1_DBL_KERNEL = DblKernel("ec_dbl_fp_mnt6753", G1_COEFF_A, 0)
G2_DBL_KERNEL = DblKernel("ec_dbl_fp3_mnt6753", G1_COEFF_A, 2)


class MNT6753:
    """Field and group objects of MNT6753, all on ``device``."""

    name = "MNT6753"
    g2_deg = 3

    def __init__(self, device):
        self.device = resolve_device(device)
        self.Fr = Fp(FIELD_B_SMALL, self.device, "MNT6753.Fr")
        self.Fq = Fp(FIELD_A, self.device, "MNT6753.Fq")
        self.Fq3 = Fp3(self.Fq, FQ3_NON_RESIDUE, "MNT6753.Fq3")
        # GT = Fq6 (the ate pairing's target, fp6_2over3.tcc)
        self.Fq6 = Fp6_2over3(self.Fq3, FQ3_NON_RESIDUE, "MNT6753.Fq6")
        self.GT = self.Fq6
        q = self.Fq.p
        self.G1 = Curve(self.Fq, self.Fq.const(G1_COEFF_A), self.Fq.const(G1_COEFF_B),
                        self.device, "MNT6753.G1", G1_ADD_KERNEL, G1_DBL_KERNEL)
        # twist coefficients: a3 = (0, 0, a), b3 = (b*nr, 0, 0) (mnt6753_init.cpp:133-137)
        zero = self.Fq.const(0)
        a3 = torch.stack([zero, zero, self.Fq.const(G1_COEFF_A)])
        b3 = torch.stack([self.Fq.const(G1_COEFF_B * FQ3_NON_RESIDUE % q), zero, zero])
        self.G2 = Curve(self.Fq3, a3, b3, self.device, "MNT6753.G2", G2_ADD_KERNEL,
                        G2_DBL_KERNEL)

    def g1_generator(self):
        """The G1 generator, projective with Z = 1 and batch () (Montgomery form)."""
        Fq = self.Fq
        return (Fq.const(G1_ONE_X), Fq.const(G1_ONE_Y), Fq.const(1))

    def g2_generator(self):
        """The G2 generator, projective with Z = 1 and batch ()."""
        Fq = self.Fq
        return (torch.stack([Fq.const(c) for c in (G2_ONE_X0, G2_ONE_X1, G2_ONE_X2)]),
                torch.stack([Fq.const(c) for c in (G2_ONE_Y0, G2_ONE_Y1, G2_ONE_Y2)]),
                torch.stack([Fq.const(1)] + [Fq.const(0)] * 2))

    def g2_mul_by_q(self, P):
        """The Frobenius endomorphism on G2 (mnt6753_g2.cpp mul_by_q,
        mnt6753_init.cpp:146-147): (tx X^q, ty Y^q, Z^q) for a projective
        batch P, the twist multipliers from ops.frobenius."""
        tx, ty = mnt6753_twist_mul_by_q()
        E, Fq = self.Fq3, self.Fq
        X, Y, Z = P
        return (E.scale_prime_const(E.frobenius_map(X, 1), Fq.const(tx)),
                E.scale_prime_const(E.frobenius_map(Y, 1), Fq.const(ty)),
                E.frobenius_map(Z, 1))


def get(device="cuda") -> MNT6753:
    """The model on ``device``: the GPU unless the caller asks for the CPU."""
    return MNT6753(device)
