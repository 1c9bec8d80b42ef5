"""The ctypes contract between the port's kernel wrappers and ``csrc/``,
checked without nvcc or a card.

* Every launcher ``_build._SIGNATURES`` declares matches the ``extern "C"``
  definition in ``csrc/<library>.cu``, argument by argument: a pointer is
  ``c_void_p``, an ``int`` ``c_int``, a ``float`` ``c_float``. A wrong entry
  would silently cut a pointer to 32 bits.
* Every ``extern "C"`` launcher of a kernel source is declared there, and
  every kernel library has its source.
* ``_build._HEADERS`` names every ``.cuh`` in ``csrc/``: a header missing
  from it would not rebuild the kernels when it changes.
"""
import ctypes
import re

import pytest

from llm_fp8_tpu_torch.kernels import _build

_LAUNCHERS = [(lib, fn) for lib, fns in sorted(_build._SIGNATURES.items()) for fn in sorted(fns)]
_DEF = re.compile(r'extern\s+"C"\s+int\s+(\w+)\s*\(([^)]*)\)\s*\{')


def _definitions(lib):
    """``{launcher: [parameter declarations]}`` of ``csrc/<lib>.cu``."""
    src = (_build.CSRC / f"{lib}.cu").read_text()
    src = re.sub(r"//[^\n]*", "", src)
    return {name: [p.strip() for p in params.split(",") if p.strip()]
            for name, params in _DEF.findall(src)}


def _ctype(param):
    if "*" in param:
        return ctypes.c_void_p
    kind = param.split()[0]
    return {"int": ctypes.c_int, "float": ctypes.c_float}[kind]


@pytest.mark.parametrize("lib,fn", _LAUNCHERS, ids=[f"{lib}.{fn}" for lib, fn in _LAUNCHERS])
def test_launcher_argtypes_match_the_c_definition(lib, fn):
    defs = _definitions(lib)
    assert fn in defs, f"csrc/{lib}.cu defines no extern \"C\" int {fn}(...)"
    want = [_ctype(p) for p in defs[fn]]
    got = _build._SIGNATURES[lib][fn]
    assert len(got) == len(want), (f"{fn}: {len(got)} argtypes for {len(want)} C parameters "
                                   f"{defs[fn]}")
    for i, (g, w, p) in enumerate(zip(got, want, defs[fn])):
        assert g is w, f"{fn} argument {i} ({p!r}): argtype {g.__name__}, want {w.__name__}"


@pytest.mark.parametrize("lib", _build.KERNELS)
def test_every_launcher_of_a_kernel_source_is_declared(lib):
    assert (_build.CSRC / f"{lib}.cu").exists()
    assert set(_definitions(lib)) == set(_build._SIGNATURES[lib])


def test_headers_name_every_shared_header():
    on_disk = {p.name for p in _build.CSRC.glob("*.cuh")}
    assert set(_build._HEADERS) == on_disk


@pytest.mark.parametrize("lib", _build.KERNELS)
def test_shared_memory_limits_are_set_once_per_kernel_instance(lib):
    """``cudaFuncSetAttribute`` runs once per kernel instance (the initializer
    of a function-local static, directly or through a helper that only such
    initializers call), never on every launch: the decode step is captured
    as a CUDA graph, and its launchers must set nothing inside a capture."""
    src = re.sub(r"//[^\n]*", "", (_build.CSRC / f"{lib}.cu").read_text())

    def statement(pos):  # the text from the statement's start up to pos
        return src[max(src.rfind(";", 0, pos), src.rfind("{", 0, pos),
                       src.rfind("}", 0, pos)) + 1:pos]

    for m in re.finditer(r"\bcudaFuncSetAttribute\s*\(", src):
        head = statement(m.start())
        if "static" in head:
            continue
        helper = re.findall(r"(\w+)\s*\([^()]*\)\s*\{", src[:m.start()])[-1]
        calls = [c.start() for c in re.finditer(rf"\b{helper}\s*\(", src)]
        uses = [c for c in calls if "static" in statement(c)]
        assert len(uses) == len(calls) - 1 and uses, (lib, head.strip())
