"""Each kernel's ctypes argument list against its C entry point.

A ``CudaKernel`` hands its arguments to the C entry point through ``ctypes``
with the ``argtypes`` it lists. A list one short shifts every argument after
the gap and crashes the launch on the card, where nothing checks it. For
every ``CudaKernel`` of ``video_vae_tpu_torch.ops``, this parses the
``extern "C" int vvt_*(...)`` signature from its ``csrc`` source and holds
the argument list to it: one entry a parameter, a pointer for a pointer, a
64-bit int for a ``long long``, a 32-bit int for an ``int``, a C float for a
``float`` (the attention entry points' softmax scale).
"""

import ctypes
import importlib
import pkgutil
import re

import pytest

import video_vae_tpu_torch.ops as ops
from video_vae_tpu_torch.ops._build import CSRC, CudaKernel

C_TYPES = {"long long": ctypes.c_longlong, "int": ctypes.c_int, "float": ctypes.c_float}


def _kernels():
    found = {}
    for info in pkgutil.iter_modules(ops.__path__):
        module = importlib.import_module(f"{ops.__name__}.{info.name}")
        for value in vars(module).values():
            if isinstance(value, CudaKernel):
                found[value.symbol] = value
    return [found[symbol] for symbol in sorted(found)]


KERNELS = _kernels()


def _parameters(kernel):
    """The C types of the entry point's parameters, as ctypes would pass them."""
    source = (CSRC / kernel.source).read_text()
    match = re.search(rf'extern "C" int {kernel.symbol}\(([^)]*)\)', source)
    assert match, f"no extern \"C\" int {kernel.symbol}(...) in csrc/{kernel.source}"
    kinds = []
    for param in match.group(1).split(","):
        decl = " ".join(param.split())
        if "*" in decl:
            kinds.append(ctypes.c_void_p)
        else:
            base = re.sub(r"^const ", "", decl).rsplit(" ", 1)[0]
            kinds.append(C_TYPES[base])
    return kinds


def test_every_kernel_is_found():
    assert len(KERNELS) == len(ops.KERNELS) == 9
    assert {k.symbol for k in KERNELS} == {k.symbol for k in ops.KERNELS}


@pytest.mark.parametrize("kernel", KERNELS, ids=lambda k: k.symbol)
def test_argtypes_match_the_entry_point(kernel):
    params = _parameters(kernel)
    assert len(kernel.argtypes) == len(params), f"{kernel.symbol}: {len(kernel.argtypes)} argtypes, {len(params)} parameters"
    for i, (listed, declared) in enumerate(zip(kernel.argtypes, params)):
        assert listed is declared, f"{kernel.symbol} parameter {i}: {listed.__name__} for {declared.__name__}"
