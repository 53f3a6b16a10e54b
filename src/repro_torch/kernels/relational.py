"""The relational elementwise kernel: FILTER masks and PROJECT values.

Replaces ``src/repro/kernels/relational.py::_elementwise_pallas``, the
Pallas kernel the JAX plane's filter and projection programs run through.
The CUDA source is ``src/repro_torch/csrc/relational.cu``; ``kernels/_build.py``
builds it with ``nvcc`` (and ``-fmad=false``) at first use into
``build/repro_torch/`` at the repository root, and it is bound with
``ctypes`` (a plain C interface, so the build takes seconds).

A ``RelProgram`` is what the kernel interprets:

  * ``prods``  — ``(column slot, coefficient)`` pairs, grouped by term;
  * ``terms``  — ``(const, code, start, count)``: the value
    ``const + sum(v * col)`` over ``prods[start:start + count]``, summed
    left to right with every multiply and add rounded on its own, and then
    either compared against the reference's +-1e-12 bands (``LE``, ``LT``,
    ``EQ``, ``NE``) or returned as a projected value (``VALUE``);
  * ``tree``   — for a mask program, the and/or/not tree in postfix order
    over terms (``ATOM``) and host-evaluated bool masks (``HOST``); empty
    for a value program.

A program has no fixed capacity.  The wrapper packs it, with the tensors'
addresses, into one int64 array (``_pack``) and sends it by one of two
routes (``route``, a function of the program alone): in the launch's
parameters when it fits their 1 KiB (``param``), else uploaded to device
memory beside the launch (``device``).  Each route is one instance of the
kernel.

``relational`` is the wrapper: on CUDA tensors it launches the kernel (or
raises); on CPU tensors it runs ``relational_reference``, the plain PyTorch
version, written as float64 ops one at a time.  ``relational.launches``
counts kernel launches, and ``relational.launches_by_instance`` counts them
by route.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.kernels import _build

MAX_DEPTH = 64  # the kernel's bool stack is one 64-bit register

# plan words the launch's parameters carry (``kParamWords`` of
# csrc/relational.cu); a larger plan goes through device memory
PARAM_WORDS = 128
ROUTES = ("param", "device")

# term codes
LE, LT, EQ, NE, VALUE = range(5)
# postfix opcodes
ATOM, HOST, TRUE, FALSE, NOT, AND, OR = range(7)

# every multiply and add rounded on its own: no FMA contraction
SOURCE = _build.CudaSource("relational", ("-fmad=false",))


@dataclass(frozen=True)
class RelProgram:
    """One filter predicate or projection, compiled for the kernel."""

    n_cols: int
    prods: Tuple[Tuple[int, float], ...]
    terms: Tuple[Tuple[float, int, int, int], ...]
    tree: Tuple[Tuple[int, int], ...] = ()
    n_hosts: int = 0

    def depth(self) -> int:
        """Peak depth of the postfix tree's bool stack (0 for a value
        program).  Ordering each and/or's deepest child first keeps it at
        most one more than log2 of the number of leaves."""
        depth = peak = 0
        for op, _ in self.tree:
            depth += 1 if op in (ATOM, HOST, TRUE, FALSE) else (-1 if op in (AND, OR) else 0)
            peak = max(peak, depth)
        return peak


Result = Union[torch.Tensor, Tuple[torch.Tensor, ...]]


# ---------------------------------------------------------------------------
# plain PyTorch version
# ---------------------------------------------------------------------------


def _compare(code: int, v: torch.Tensor) -> torch.Tensor:
    if code == LE:
        return v <= 1e-12
    if code == LT:
        return v < -1e-12
    if code == EQ:
        return v.abs() <= 1e-12
    return v.abs() > 1e-12


def relational_reference(
    program: RelProgram, cols: Sequence[torch.Tensor], hosts: Sequence[torch.Tensor] = ()
) -> Result:
    """The kernel's function in torch float64 ops, one op at a time: a bool
    mask for a mask program, one float64 tensor per term otherwise."""
    n = cols[0].shape[0]
    dev = cols[0].device

    def term(t: int) -> torch.Tensor:
        const, _, start, count = program.terms[t]
        acc = torch.full((n,), const, dtype=torch.float64, device=dev)
        for slot, v in program.prods[start:start + count]:
            acc = acc + v * cols[slot].to(torch.float64)
        return acc

    if not program.tree:
        return tuple(term(t) for t in range(len(program.terms)))
    stack: List[torch.Tensor] = []
    for op, arg in program.tree:
        if op == ATOM:
            stack.append(_compare(program.terms[arg][1], term(arg)))
        elif op == HOST:
            stack.append(hosts[arg])
        elif op == TRUE:
            stack.append(torch.ones(n, dtype=torch.bool, device=dev))
        elif op == FALSE:
            stack.append(torch.zeros(n, dtype=torch.bool, device=dev))
        elif op == NOT:
            stack.append(~stack.pop())
        else:
            top = stack.pop()
            stack.append(stack.pop() & top if op == AND else stack.pop() | top)
    return stack.pop()


# ---------------------------------------------------------------------------
# the wrapper
# ---------------------------------------------------------------------------


def relational(
    program: RelProgram, cols: Sequence[torch.Tensor], hosts: Sequence[torch.Tensor] = ()
) -> Result:
    """Run ``program``: the CUDA kernel for CUDA tensors, the plain version
    for CPU tensors, and ``ValueError`` for anything else."""
    tensors = list(cols) + list(hosts)
    if not cols:
        raise ValueError("a relational program reads at least one column")
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return relational_reference(program, cols, hosts)
    if kinds != {"cuda"} or len({t.device for t in tensors}) != 1:
        raise ValueError(f"relational kernel needs tensors on one CUDA device, got {kinds}")
    return _launch(program, cols, hosts)


relational.launches = 0
relational.launches_by_instance = dict.fromkeys(ROUTES, 0)


@functools.lru_cache(maxsize=1)
def host_default_nan() -> int:
    """Bit pattern of the NaN this host's numpy makes for an invalid
    operation (inf - inf), as a signed 64-bit word; the kernel makes the
    same one."""
    with np.errstate(invalid="ignore"):
        nan = np.array([np.inf]) - np.array([np.inf])
    return int(nan.view(np.int64)[0])


# header fields of a packed plan, in the order of ``H_*`` in csrc/relational.cu
_HEADER = ("n_terms", "n_prog", "default_nan", "col", "is_int", "host", "out", "prod",
           "term", "prog")


def plan_words(program: RelProgram) -> int:
    """Length of ``program``'s packed plan in 64-bit words."""
    return len(_template(program)[0])


def route(program: RelProgram) -> str:
    """How ``program``'s plan reaches the kernel: ``"param"`` when the
    launch's parameters hold it, else ``"device"``.  A function of the
    program alone; each route is one instance of the kernel."""
    return "param" if plan_words(program) <= PARAM_WORDS else "device"


@functools.lru_cache(maxsize=256)
def _template(program: RelProgram) -> Tuple[np.ndarray, Dict[str, int]]:
    """The packed plan of ``program`` without the tensors' addresses, and
    its section offsets: built once per program."""
    n_outs = 1 if program.tree else len(program.terms)
    sizes = {"col": program.n_cols, "is_int": program.n_cols, "host": program.n_hosts,
             "out": n_outs, "prod": 2 * len(program.prods), "term": 4 * len(program.terms),
             "prog": 2 * len(program.tree)}
    offset = {}
    at = len(_HEADER)
    for name, size in sizes.items():
        offset[name] = at
        at += size
    words = np.zeros(at, dtype=np.int64)
    words[:3] = (len(program.terms), len(program.tree), host_default_nan())
    words[3:len(_HEADER)] = [offset[name] for name in _HEADER[3:]]
    if program.prods:
        prods = words[offset["prod"]:offset["term"]].reshape(-1, 2)
        prods[:, 0] = [slot for slot, _ in program.prods]
        prods[:, 1] = np.array([v for _, v in program.prods], dtype=np.float64).view(np.int64)
    if program.terms:
        terms = words[offset["term"]:offset["prog"]].reshape(-1, 4)
        terms[:, 0] = np.array([t[0] for t in program.terms], dtype=np.float64).view(np.int64)
        terms[:, 1:] = [t[1:] for t in program.terms]
    if program.tree:
        words[offset["prog"]:].reshape(-1, 2)[:] = program.tree
    words.flags.writeable = False
    return words, offset


def _pack(program: RelProgram, cols: Sequence[torch.Tensor], hosts: Sequence[torch.Tensor],
          outs: Sequence[torch.Tensor]) -> np.ndarray:
    """The plan as the kernel reads it: one int64 array, a header of
    counts and section offsets, then the sections (see csrc/relational.cu)."""
    template, offset = _template(program)
    words = template.copy()
    k = offset["col"]
    words[k:k + len(cols)] = [t.data_ptr() for t in cols]
    k = offset["is_int"]
    words[k:k + len(cols)] = [t.dtype == torch.int64 for t in cols]
    k = offset["host"]
    words[k:k + len(hosts)] = [t.data_ptr() for t in hosts]
    k = offset["out"]
    words[k:k + len(outs)] = [t.data_ptr() for t in outs]
    return words


def _launch(
    program: RelProgram, cols: Sequence[torch.Tensor], hosts: Sequence[torch.Tensor]
) -> Result:
    if len(cols) != program.n_cols or len(hosts) != program.n_hosts:
        raise ValueError("column or host-mask count does not match the program")
    if program.depth() > MAX_DEPTH:
        raise ValueError(f"predicate tree needs a stack of {program.depth()} > {MAX_DEPTH}")
    n = cols[0].shape[0]
    for t in cols:
        if t.dtype not in (torch.float64, torch.int64):
            raise ValueError(f"relational kernel reads float64 or int64 columns, got {t.dtype}")
    for t in hosts:
        if t.dtype != torch.bool:
            raise ValueError(f"host masks must be bool, got {t.dtype}")
    for t in list(cols) + list(hosts):
        if t.dim() != 1 or t.shape[0] != n or not t.is_contiguous():
            raise ValueError("relational kernel needs contiguous 1-D tensors of one length")
    dev = cols[0].device
    if program.tree:
        outs = [torch.empty(n, dtype=torch.bool, device=dev)]
    else:
        outs = [torch.empty(n, dtype=torch.float64, device=dev) for _ in program.terms]
    result: Result = outs[0] if program.tree else tuple(outs)
    if n == 0:
        return result

    lib = _library()
    way = route(program)
    words = _pack(program, cols, hosts, outs)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if way == "device":
            # pinned, so the upload is queued on the stream like the launch;
            # the caching host allocator keeps the buffer until the copy has run
            plan = torch.from_numpy(words).pin_memory().to(dev, non_blocking=True)
            rc = lib.veer_relational_launch_device(plan.data_ptr(), n, len(cols), len(hosts),
                                                   stream)
        else:  # the words are copied into the launch's parameters
            rc = lib.veer_relational_launch_params(words.ctypes.data, len(words), n, len(cols),
                                                   len(hosts), stream)
    _build.check(lib, rc, "relational kernel")
    relational.launches += 1
    relational.launches_by_instance[way] += 1
    return result


# ---------------------------------------------------------------------------
# build
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    lib.veer_relational_header_words.argtypes = []
    lib.veer_relational_header_words.restype = ctypes.c_int
    lib.veer_relational_launch_params.argtypes = [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p,
    ]
    lib.veer_relational_launch_params.restype = ctypes.c_int
    lib.veer_relational_launch_device.argtypes = [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.veer_relational_launch_device.restype = ctypes.c_int
    if lib.veer_relational_header_words() != len(_HEADER):
        raise RuntimeError(
            "csrc/relational.cu plan header does not match kernels/relational.py"
        )
    return lib
