"""ctypes bridge over the camlsnark_* C ABI (the repo's ``native/caml_ffi.cpp``).

Counterpart of the JAX package's ``io/caml_ffi.py``.  The reference exposes
its circuit layer to OCaml (Mina's snarky) through some 200 extern "C"
entry points a curve (libsnark/caml/caml_mnt4753.cpp).  The native library
serves that surface for building circuits (protoboard, variables, linear
combinations, R1CS, Fr and bigint arithmetic); this module loads it, walks a
natively built constraint system out through
``camlsnark_*_r1cs_constraint_system_iter`` into ``relations/r1cs.py``, and
hands the keys and proofs of ``proof_systems/groth16_full`` to the native
string entry points in libsnark's bytes (``io/caml_serialization.py``):

    ffi = CamlFFI("MNT4753")
    pb = ffi.protoboard()
    x = pb.allocate()                       # snarky-style witness building
    ...
    cs, primary, aux = pb.extract()
    kp = groth16_full.generator(model, cs, rng)   # keys and proofs on the card

``libcamlsnark.so`` is built at first use from ``native/caml_ffi.cpp`` and
``native/algebra753.hpp`` with ``g++`` and ``native/Makefile``'s flags, into
the port's ``_build/``, keyed on a hash of the sources and the flags; a
failed build raises with the compiler's output.  Every handle the library
returns is kept as a ``ctypes.c_void_p``: a bare Python int passed back to
a function without argument types would go as a 32-bit C int and cut the
pointer.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import struct
import subprocess
from pathlib import Path

from ..relations.r1cs import LinearCombination, R1CSConstraint, R1CSConstraintSystem
from . import caml_serialization as cser

PKG = Path(__file__).resolve().parent.parent
NATIVE = PKG.parent / "native"
BUILD = PKG / "_build"
SOURCES = ("caml_ffi.cpp", "algebra753.hpp")
# native/Makefile's CXXFLAGS and its libcamlsnark.so rule
CXX_FLAGS = ["-O3", "-march=native", "-fPIC", "-fopenmp", "-Wall", "-Wextra", "-shared"]

_lib = None
_ITER_CB = ctypes.CFUNCTYPE(None, ctypes.c_void_p)


def library_path() -> Path:
    """Where the library for these sources and flags is (or will be) built."""
    h = hashlib.sha256()
    for name in SOURCES:
        h.update(name.encode())
        h.update((NATIVE / name).read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD / f"libcamlsnark-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Build ``libcamlsnark.so`` unless it is built for these sources; its path."""
    out = library_path()
    if out.exists():
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: libcamlsnark.so is built from native/ with g++")
    BUILD.mkdir(exist_ok=True)
    tmp = out.with_suffix(f".tmp{os.getpid()}.so")
    cmd = [cxx, *CXX_FLAGS, "-o", str(tmp), str(NATIVE / "caml_ffi.cpp")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building libcamlsnark.so failed:\n$ {' '.join(cmd)}\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def load() -> ctypes.CDLL:
    """The camlsnark library, built at first use."""
    global _lib
    if _lib is None:
        _lib = ctypes.CDLL(str(build()))
    return _lib


def r1cs_digest(cs: R1CSConstraintSystem) -> bytes:
    """The MD5 digest that ``camlsnark_*_r1cs_constraint_system_digest``
    computes (caml_mnt4753.cpp:493-524): over every constraint's a, b and c
    terms in order, the index as an 8-byte size_t and the coefficient as
    96 canonical little-endian bytes."""
    h = hashlib.md5()
    for c in cs.constraints:
        for lc in (c.a, c.b, c.c):
            for idx, coeff in lc.terms:
                h.update(struct.pack("<Q", idx) + (coeff % cs.p).to_bytes(96, "little"))
    return h.digest()


class CamlFFI:
    """One curve's view of the camlsnark_* symbols."""

    def __init__(self, curve: str = "MNT4753"):
        self.lib = load()
        self.prefix = f"camlsnark_{curve.lower()}"
        self.curve = curve
        self._fns = {}
        self._p = None
        self("init_public_params", restype=None)

    def fn(self, name: str, restype=ctypes.c_void_p, argtypes=None):
        """The symbol ``<prefix>_<name>``, its types set at its first use."""
        f = self._fns.get(name)
        if f is None:
            f = getattr(self.lib, f"{self.prefix}_{name}")
            f.restype = restype
            if argtypes is not None:
                f.argtypes = argtypes
            self._fns[name] = f
        return f

    def __call__(self, name: str, *args, restype=ctypes.c_void_p):
        """Call ``<prefix>_<name>``: handles go as ``c_void_p``, plain ints
        (sizes, indices) as C ints, bytes as char*; a handle comes back as
        a ``c_void_p``."""
        res = self.fn(name, restype=restype)(*args)
        return ctypes.c_void_p(res) if restype is ctypes.c_void_p else res

    # ---- field / bigint marshalling ------------------------------------
    def _bigint_bytes(self, big) -> int:
        data = self.fn("bigint_r_to_data", restype=ctypes.POINTER(ctypes.c_char))(big)
        return int.from_bytes(ctypes.string_at(data, 96), "little")

    def field_of_int_value(self, v: int):
        """Python int -> a field element handle."""
        big = self("bigint_r_of_data", (v % self.modulus()).to_bytes(96, "little"))
        f = self("bigint_r_to_field", big)
        self("bigint_r_delete", big, restype=None)
        return f

    def field_to_int(self, f) -> int:
        big = self("bigint_r_of_field", f)
        v = self._bigint_bytes(big)
        self("bigint_r_delete", big, restype=None)
        return v

    def modulus(self) -> int:
        if self._p is None:
            big = self("field_size")
            self._p = self._bigint_bytes(big)
            self("bigint_r_delete", big, restype=None)
        return self._p

    def protoboard(self) -> "CamlProtoboard":
        return CamlProtoboard(self)

    # ---- native strings ------------------------------------------------
    def read_string(self, handle, delete: bool = True) -> bytes:
        n = self("string_length", handle, restype=ctypes.c_int)
        data = self.fn("string_data", restype=ctypes.POINTER(ctypes.c_char))(handle)
        out = ctypes.string_at(data, n)
        if delete:
            self("string_delete", handle, restype=None)
        return out

    def make_string(self, data: bytes) -> ctypes.c_void_p:
        f = self.fn("string_of_bytes", argtypes=[ctypes.c_char_p, ctypes.c_int])
        return ctypes.c_void_p(f(data, len(data)))

    # ---- keys and proofs through the string entry points
    # (caml_mnt4753.cpp:644-693): libsnark's bytes, io.caml_serialization
    def _through_native(self, kind: str, encoded: bytes) -> bytes:
        """``encoded`` through ``<kind>_of_string`` and ``<kind>_to_string``."""
        s = self.make_string(encoded)
        h = self(f"{kind}_of_string", s)
        self("string_delete", s, restype=None)
        data = self.read_string(self(f"{kind}_to_string", h))
        self(f"{kind}_delete", h, restype=None)
        return data

    def proving_key_to_string(self, pk) -> bytes:
        return self._through_native("proving_key", cser.proving_key_to_bytes(pk))

    def proving_key_of_string(self, data: bytes, device="cuda"):
        return cser.proving_key_from_bytes(self.curve, data, device)

    def verification_key_to_string(self, vk) -> bytes:
        return self._through_native("verification_key", cser.verification_key_to_bytes(vk))

    def verification_key_of_string(self, data: bytes):
        return cser.verification_key_from_bytes(self.curve, data)

    def proof_to_string(self, proof) -> bytes:
        return self._through_native("proof", cser.proof_to_bytes_caml(self.curve, proof))

    def proof_of_string(self, data: bytes):
        return cser.proof_from_bytes_caml(self.curve, data)


class CamlProtoboard:
    """Snarky-style circuit construction on the native protoboard."""

    def __init__(self, ffi: CamlFFI):
        self.ffi = ffi
        self.pb = ffi("protoboard_create")

    def set_input_sizes(self, n: int):
        self.ffi("protoboard_set_input_sizes", self.pb, n, restype=None)

    def allocate(self):
        """One new variable: its Var handle."""
        return self.ffi("protoboard_allocate_variable", self.pb)

    def var_index(self, var) -> int:
        return self.ffi("protoboard_variable_index", var, restype=ctypes.c_int)

    def set(self, var, value: int):
        f = self.ffi.field_of_int_value(value)
        self.ffi("protoboard_set_variable", self.pb, var, f, restype=None)
        self.ffi("field_delete", f, restype=None)

    def get(self, var) -> int:
        f = self.ffi("protoboard_get_variable", self.pb, var)
        v = self.ffi.field_to_int(f)
        self.ffi("field_delete", f, restype=None)
        return v

    def lc(self, terms):
        """[(coeff, var)] -> a LinComb handle; an int var is a wire index
        (0 the constant one), as camlsnark_*_var_create takes it."""
        ffi = self.ffi
        out = ffi("linear_combination_create")
        for coeff, var in terms:
            f = ffi.field_of_int_value(coeff)
            is_idx = isinstance(var, int)
            v = ffi("var_create", var) if is_idx else var
            ffi("linear_combination_add_term", out, f, v, restype=None)
            ffi("field_delete", f, restype=None)
            if is_idx:
                ffi("var_delete", v, restype=None)
        return out

    def add_constraint(self, a, b, c):
        con = self.ffi("r1cs_constraint_create", a, b, c)
        self.ffi("protoboard_add_r1cs_constraint", self.pb, con, restype=None)
        self.ffi("r1cs_constraint_delete", con, restype=None)

    def num_variables(self) -> int:
        return self.ffi("protoboard_num_variables", self.pb, restype=ctypes.c_int)

    # ---- extraction into the port --------------------------------------
    def _lc_of(self, handle) -> LinearCombination:
        ffi = self.ffi
        terms_h = ffi("linear_combination_terms", handle)
        terms = []
        for i in range(ffi("linear_combination_term_vector_length", terms_h,
                           restype=ctypes.c_int)):
            t = ffi("linear_combination_term_vector_get", terms_h, i)
            idx = ffi("linear_combination_term_index", t, restype=ctypes.c_int)
            coeff_h = ffi("linear_combination_term_coeff", t)
            terms.append((idx, ffi.field_to_int(coeff_h)))
            ffi("field_delete", coeff_h, restype=None)
            ffi("linear_combination_term_delete", t, restype=None)
        ffi("linear_combination_term_vector_delete", terms_h, restype=None)
        return LinearCombination(terms)

    def _field_vector(self, name: str) -> list:
        ffi = self.ffi
        h = ffi(name, self.pb)
        out = []
        for i in range(ffi("field_vector_length", h, restype=ctypes.c_int)):
            f = ffi("field_vector_get", h, i)
            out.append(ffi.field_to_int(f))
            ffi("field_delete", f, restype=None)
        ffi("field_vector_delete", h, restype=None)
        return out

    def extract(self):
        """-> (relations.r1cs.R1CSConstraintSystem, primary, auxiliary)."""
        ffi = self.ffi
        sys_h = ffi("protoboard_constraint_system", self.pb)
        cs = R1CSConstraintSystem(
            ffi.modulus(),
            primary_input_size=ffi("r1cs_constraint_system_get_primary_input_size", sys_h,
                                   restype=ctypes.c_size_t),
            auxiliary_input_size=ffi("r1cs_constraint_system_get_auxiliary_input_size", sys_h,
                                     restype=ctypes.c_size_t))

        failed = []  # ctypes drops what a callback raises: kept here, raised after

        @_ITER_CB
        def on_constraint(con_ptr):
            if failed:
                return
            try:
                con = ctypes.c_void_p(con_ptr)
                parts = [ffi(f"r1cs_constraint_{k}", con) for k in "abc"]
                cs.add_constraint(R1CSConstraint(*(self._lc_of(h) for h in parts)))
                for h in parts:
                    ffi("linear_combination_delete", h, restype=None)
            except BaseException as e:  # noqa: BLE001 - re-raised below
                failed.append(e)

        ffi.fn("r1cs_constraint_system_iter", restype=None,
               argtypes=[ctypes.c_void_p, _ITER_CB])(sys_h, on_constraint)
        ffi("r1cs_constraint_system_delete", sys_h, restype=None)
        if failed:
            raise failed[0]
        return (cs, self._field_vector("protoboard_primary_input"),
                self._field_vector("protoboard_auxiliary_input"))

    def digest(self) -> bytes:
        """The constraint system's MD5 digest (caml_mnt4753.cpp:507-524 layout)."""
        ffi = self.ffi
        sys_h = ffi("protoboard_constraint_system", self.pb)
        out = ffi.read_string(ffi("r1cs_constraint_system_digest", sys_h))
        ffi("r1cs_constraint_system_delete", sys_h, restype=None)
        return out
