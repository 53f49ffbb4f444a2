"""The ring-push kernel: CUDA on Hopper, with its plain PyTorch version.

Port of ``blockchain_simulator_tpu/ops/ring_kernel.py`` ``fused_push`` (the
repo's one Pallas TPU kernel): in place, ``buf[(t+lo+b) % D] op= contrib[b]``
for every bucket ``b < B <= D``, ``op`` in {add, max}.  The kernel is
``csrc/ring_push.cu`` (its header says what bounds it), compiled with ``nvcc``
for ``sm_90a`` into a shared library with a plain C interface and loaded with
``ctypes``.  It is built at first CUDA use into ``build/kernels/`` at the
checkout root, from the checkout's own source.

One launch applies a GROUP of pushes: ``items`` is a sequence of
``(ring, lo, contrib, op)``, each member on its own ring, all at one tick
``t``.  :func:`plan_group` checks the group and lays out its launch (one
descriptor per member: pointers, sizes, the int4-or-scalar choice and the
member's first block); it is plain Python, so the CPU tests reach it.  The
single push (:func:`fused_push`) is a group of one through the same kernel.

Routing (:func:`push_group`, :func:`push`): a CUDA ring always launches the
kernel, and a failed build or launch raises; a CPU ring takes the plain
version (:func:`push_group_plain`, the sequential :func:`push_plain` loop;
:func:`push_plain` is the per-bucket loop of the JAX package's DUS chain,
``ops/ring._push``).  ``chip_smoke.py`` holds the kernel against it on the
card.  ``launches`` counts kernel launches and ``pushes`` the members they
applied; the plain path counts neither.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import struct
import subprocess
import threading
from typing import NamedTuple

import torch

_PKG = pathlib.Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "ring_push.cu"
BUILD_DIR = _PKG.parent / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
_OPS = {"add": 0, "max": 1}
_I32 = torch.int32

# The kernel's layout (csrc/ring_push.cu, checked against the library by load)
MAX_MEMBERS = 32          # kMaxMembers: pushes one launch can apply
ELEMS_PER_BLOCK = 2048    # kElemsPerBlock: int32 elements of one (bucket, chunk) block
# struct PushDesc: buf, contrib, len, lo, depth, buckets, op, vec, chunks,
# first_block, reserved — 56 bytes, native alignment
_DESC = struct.Struct("=QQq8i")

launches = 0  # kernel launches since the last reset (the plain path never counts)
pushes = 0    # group members those launches applied

_lib = None
_launch = None  # the library's ring_push_group_i32, bound once by load()
_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = pathlib.Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): "
                       "the ring-push kernel cannot be built")


def build() -> tuple[pathlib.Path, str]:
    """Compile ``csrc/ring_push.cu`` (if the library for this exact source
    and these flags is not built yet).  Returns ``(library path, compiler
    output)`` — ptxas prints registers and spills; raises on a compiler
    error."""
    src = SOURCE.read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    out = BUILD_DIR / f"libring_push_{tag}.so"
    if out.exists():
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out, proc.stdout + proc.stderr


def load():
    """Build (once) and load the kernel library, check that its layout is
    the one this module packs, and bind the launch function so later calls
    take no lock."""
    global _lib, _launch
    with _lock:
        if _lib is None:
            path, _ = build()
            lib = ctypes.CDLL(str(path))
            layout = (ctypes.c_int * 3)()
            lib.ring_push_layout.argtypes = [ctypes.c_void_p]
            lib.ring_push_layout(layout)
            if tuple(layout) != (MAX_MEMBERS, ELEMS_PER_BLOCK, _DESC.size):
                raise RuntimeError(f"ring_push.cu layout {tuple(layout)} != binding "
                                   f"{(MAX_MEMBERS, ELEMS_PER_BLOCK, _DESC.size)}")
            lib.ring_push_group_i32.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                                ctypes.c_void_p, ctypes.c_void_p]
            lib.ring_push_group_i32.restype = ctypes.c_int
            lib.ring_push_error_string.argtypes = [ctypes.c_int]
            lib.ring_push_error_string.restype = ctypes.c_char_p
            _lib = lib
            _launch = lib.ring_push_group_i32
    return _lib


def _check_t(t) -> None:
    if not torch.is_tensor(t) or t.numel() != 1:
        raise TypeError("t is a one-element tensor on the ring's device")


def _check(buf, lo, contrib, op) -> int:
    """Validate one push (not its tick); returns the kernel's op code."""
    code = _OPS.get(op)
    if code is None:
        raise ValueError(f"ring push op must be 'add' or 'max', got {op!r}")
    if buf.dtype is not _I32 or contrib.dtype is not _I32:
        raise TypeError(f"ring push takes int32 tensors, got {buf.dtype} ring "
                        f"and {contrib.dtype} contribution")
    bs, cs = buf.shape, contrib.shape
    if bs[1:] != cs[1:]:
        raise ValueError(f"ring rest shape {tuple(bs[1:])} != "
                         f"contribution rest shape {tuple(cs[1:])}")
    if cs[0] > bs[0]:
        raise ValueError(f"B = {cs[0]} buckets exceed ring depth D = {bs[0]}")
    if type(lo) is not int:
        raise TypeError("lo is a static Python int offset")
    return code


class GroupPlan(NamedTuple):
    """A group's launch: one descriptor per non-empty member (the fields of
    ``struct PushDesc``, in order) and the grid's block count."""
    descs: tuple
    blocks: int

    @property
    def first_block(self) -> tuple:
        """The block prefixes: member i's blocks are
        ``[first_block[i], first_block[i + 1])``."""
        return tuple(d[9] for d in self.descs)

    @property
    def vec(self) -> tuple:
        """Per member: True for the 16-byte (int4) path, False for scalar."""
        return tuple(bool(d[7]) for d in self.descs)


def plan_group(items) -> GroupPlan:
    """Check a group and lay out its launch.  Every member is checked as a
    single push; all tensors are contiguous and lie on one device; at most
    ``MAX_MEMBERS`` members; no two members on one ring and no contribution
    overlapping any member's ring, since the kernel applies the members in
    no order (contributions may share memory).  The plain version refuses
    the same groups.  A member with no element to push gets no descriptor;
    the others get their block prefix and the int4-or-scalar choice.  The
    tick loop pays this on every call, so it reads each tensor attribute
    once."""
    if len(items) > MAX_MEMBERS:
        raise ValueError(f"a push group holds at most {MAX_MEMBERS} members, "
                         f"got {len(items)}")
    descs = []
    rings = []  # (first, last, member) byte spans of the non-empty tensors
    contribs = []
    first = 0
    dev = items[0][0].device if items else None
    for i, (buf, lo, contrib, op) in enumerate(items):
        code = _OPS.get(op)
        bs, cs = buf.shape, contrib.shape
        if (code is None or buf.dtype is not _I32 or contrib.dtype is not _I32
                or bs[1:] != cs[1:] or cs[0] > bs[0] or type(lo) is not int):
            _check(buf, lo, contrib, op)  # raises, naming what is wrong
        if buf.device != dev or contrib.device != dev:
            raise ValueError(f"a push group lies on one device, got {dev}, "
                             f"{buf.device} and {contrib.device}")
        bp, cp = buf.data_ptr(), contrib.data_ptr()
        d, b = bs[0], cs[0]
        length = buf.numel() // d if d else 0
        if not (buf.is_contiguous() and contrib.is_contiguous()):
            raise ValueError("a push group takes contiguous rings and contributions")
        if d and length:
            rings.append((bp, bp + 4 * d * length, i))
        if b and length:
            contribs.append((cp, cp + 4 * b * length, i))
            vec = int(length % 4 == 0 and bp % 16 == 0 and cp % 16 == 0)
            chunks = -(-length // ELEMS_PER_BLOCK)
            descs.append((bp, cp, length, lo, d, b, code, vec, chunks, first, 0))
            first += b * chunks
    for k, (r0, r1, i) in enumerate(rings):
        for s0, s1, j in rings[:k]:
            if r0 < s1 and s0 < r1:
                raise ValueError(f"push group members {j} and {i} share ring storage")
        for c0, c1, j in contribs:
            if c0 < r1 and r0 < c1:
                raise ValueError(f"the contribution of member {j} overlaps the ring "
                                 f"of member {i}")
    if first >= 2**31:
        raise ValueError(f"push group needs {first} blocks, more than one grid holds")
    return GroupPlan(tuple(descs), first)


def fused_push_group(items, t):
    """Launch the CUDA kernel once for the whole group: in place on every
    member's ring.  ``t`` is a one-element int32 tensor on the card, read by
    the kernel itself."""
    plan = plan_group(items)
    _check_t(t)
    dev = items[0][0].device if items else t.device
    if dev.type != "cuda" or t.device != dev:
        raise ValueError(f"fused_push_group needs rings, contributions and t on "
                         f"one CUDA device, got {dev} and t on {t.device}")
    if t.dtype is not _I32:
        raise TypeError(f"t must be int32, got {t.dtype}")
    descs = plan.descs
    k = len(descs)
    if k == 0:
        return
    launch = _launch
    if launch is None:
        load()
        launch = _launch
    # the raw handle of the current stream (what torch.cuda.current_stream
    # wraps), without building a Stream object on every launch
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    rc = launch(b"".join([_DESC.pack(*d) for d in descs]), k, t.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"ring_push launch failed: "
                           f"{_lib.ring_push_error_string(rc).decode()} ({rc})")
    global launches, pushes
    launches += 1
    pushes += k


def push_plain(buf, t, lo: int, contrib, op: str):
    """Plain PyTorch version of one push, in place: the per-bucket loop
    ``buf[idx] = combine(buf[idx], contrib[b])``.  Indexing goes through
    tensors, so it also runs on the card without a host sync."""
    _check(buf, lo, contrib, op)
    _check_t(t)
    combine = torch.add if op == "add" else torch.maximum
    d = buf.shape[0]
    t = t.reshape(1).to(device=buf.device, dtype=torch.int64)
    for b in range(contrib.shape[0]):
        idx = torch.remainder(t + lo + b, d)
        buf.index_copy_(0, idx, combine(buf.index_select(0, idx), contrib[b:b + 1]))
    return buf


def push_group_plain(items, t):
    """Plain version of a group: the same checks as the kernel's, then
    :func:`push_plain` member after member."""
    plan_group(items)
    _check_t(t)
    for buf, lo, contrib, op in items:
        push_plain(buf, t, lo, contrib, op)


def push_group(items, t):
    """Route a group: the kernel for CUDA rings, the plain version for CPU
    rings.  Nothing falls back from one to the other."""
    if not items:
        return
    dev = items[0][0].device
    if dev.type == "cuda":
        return fused_push_group(items, t)
    if dev.type != "cpu":
        raise ValueError(f"no ring push for device {dev}")
    return push_group_plain(items, t)


def fused_push(buf, t, lo: int, contrib, op: str):
    """One push through the kernel (a group of one); returns ``buf``."""
    fused_push_group(((buf, lo, contrib, op),), t)
    return buf


def push(buf, t, lo: int, contrib, op: str):
    """Route one push as :func:`push_group` does; returns ``buf``."""
    push_group(((buf, lo, contrib, op),), t)
    return buf
