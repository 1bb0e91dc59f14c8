"""State files: the port's own, the JAX package's msgpack state files and
the reference's safetensors (port of the JAX package's
``training/checkpoint.py``).

Three formats, told apart by their first bytes (``sniff_format``):

* ``"torch"``: the port's own trainer state, a ``torch.save`` zip
  (``PK\\x03\\x04``), written atomically by ``save_torch``;
* ``"safetensors"``: the reference's weights (``autoencoder.safetensors``,
  ``discriminator.safetensors``, ``transformer.safetensors``): an 8-byte
  little-endian header length, a JSON header, then raw bytes;
* ``"msgpack"``: the JAX package's msgpack state file, a full train state
  (``params``, optimizer states, ``step``) or a bare parameter tree.

Both readers are plain Python and numpy over a copy-on-write memory map of
the file: each array is a view of the map (a 23 GB ``dit`` state is not
read into memory twice), returned as a CPU tensor; bf16 leaves are read as
uint16 and viewed as ``torch.bfloat16``. ``tolerant_restore`` copies what
matches a target state_dict by name and shape and reports the rest, as the
JAX package's loads do; ``load_params_any`` reads one model's parameters
from any of the three formats.
"""

from __future__ import annotations

import json
import mmap
import os
import struct
import zipfile
from typing import Dict, Iterable, List, Optional

import numpy as np
import torch
from torch import nn

from sigman_release_torch import convert
from sigman_release_torch.parallel.mesh import rank_seed


class UnknownFormat(NotImplementedError):
    """A file in none of the formats this module reads."""


def sniff_format(path: str) -> str:
    """``"torch"``, ``"safetensors"`` or ``"msgpack"`` from the first bytes:
    a zip header is the port's file; 8 length bytes followed by ``{`` a
    safetensors header (a msgpack map head never is); anything else is
    taken for msgpack."""
    with open(path, "rb") as f:
        head = f.read(9)
    if head[:4] == b"PK\x03\x04":
        return "torch"
    if len(head) == 9 and head[8:9] == b"{":
        n = int.from_bytes(head[:8], "little")
        if 2 <= n <= os.path.getsize(path):
            return "safetensors"
    return "msgpack"


def _map_file(path: str) -> memoryview:
    """The file as a writable copy-on-write map: arrays viewed on it are
    writable without a copy (the file itself is never written)."""
    if os.path.getsize(path) == 0:
        raise UnknownFormat(f"{path}: empty, not a state file that "
                            f"training/checkpoint.py reads")
    with open(path, "rb") as f:
        return memoryview(mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY))


def _tensor(buf: memoryview, dtype: str, shape) -> torch.Tensor:
    """A CPU tensor viewing ``buf``; numpy's dtype names, plus bfloat16."""
    if dtype == "bfloat16":
        arr = np.frombuffer(buf, np.uint16)
        return torch.from_numpy(arr).view(torch.bfloat16).reshape(shape)
    return torch.from_numpy(np.frombuffer(buf, np.dtype(dtype)).reshape(shape))


# ---------------------------------------------------------------- msgpack

# ext types of the JAX package's serializer: an ndarray and a numpy scalar,
# each a msgpack-packed (shape, dtype name, C-order bytes)
EXT_NDARRAY, EXT_NPSCALAR = 1, 3
CHUNKED = "__msgpack_chunked_array__"


class _Msgpack:
    """A msgpack decoder over a memoryview: maps, arrays, str, bin (a view),
    ints, floats, bool, nil and the two ext types above."""

    def __init__(self, buf: memoryview):
        self.buf, self.pos = buf, 0

    def _take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("truncated msgpack data")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def _unpack(self, fmt: str):
        return struct.unpack(fmt, self._take(struct.calcsize(fmt)))[0]

    def value(self):
        b = self._unpack(">B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self._map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.value() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return str(self._take(b & 0x1F), "utf-8")
        if b == 0xC0:
            return None
        if b in (0xC2, 0xC3):
            return b == 0xC3
        if b in (0xC4, 0xC5, 0xC6):           # bin 8/16/32
            return self._take(self._unpack(">" + "BHI"[b - 0xC4]))
        if b in (0xC7, 0xC8, 0xC9):           # ext 8/16/32
            n = self._unpack(">" + "BHI"[b - 0xC7])
            return self._ext(self._unpack(">b"), n)
        if b in (0xCA, 0xCB):
            return self._unpack(">f" if b == 0xCA else ">d")
        if 0xCC <= b <= 0xD3:                 # uint / int 8-64
            return self._unpack(">" + "BHIQbhiq"[b - 0xCC])
        if 0xD4 <= b <= 0xD8:                 # fixext 1-16
            code = self._unpack(">b")
            return self._ext(code, 1 << (b - 0xD4))
        if b in (0xD9, 0xDA, 0xDB):           # str 8/16/32
            n = self._unpack(">" + "BHI"[b - 0xD9])
            return str(self._take(n), "utf-8")
        if b in (0xDC, 0xDD):
            n = self._unpack(">H" if b == 0xDC else ">I")
            return [self.value() for _ in range(n)]
        if b in (0xDE, 0xDF):
            return self._map(self._unpack(">H" if b == 0xDE else ">I"))
        raise ValueError(f"msgpack: unused type byte 0x{b:02x}")

    def _map(self, n: int):
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        if out.get(CHUNKED) is True:
            shape = tuple(out["shape"][str(i)]
                          for i in range(len(out["shape"])))
            chunks = [out["chunks"][str(i)]
                      for i in range(len(out["chunks"]))]
            return torch.cat([c.reshape(-1) for c in chunks]).reshape(shape)
        return out

    def _ext(self, code: int, n: int):
        payload = self._take(n)
        if code not in (EXT_NDARRAY, EXT_NPSCALAR):
            raise ValueError(f"msgpack: unknown ext type {code}")
        shape, dtype, data = _Msgpack(payload).value()
        t = _tensor(data, dtype, tuple(shape))
        return t.reshape(()) if code == EXT_NPSCALAR else t


def read_msgpack(path: str) -> dict:
    """The JAX package's msgpack state file -> a nested dict with CPU tensor
    leaves (viewing the file's map) and Python scalars; optimizer tuples
    are dicts indexed ``"0"``, ``"1"``, ..."""
    buf = _map_file(path)
    if not (0x80 <= buf[0] <= 0x8F or buf[0] in (0xDE, 0xDF)):
        raise UnknownFormat(
            f"{path}: not a state file that training/checkpoint.py reads "
            f"(the port's torch.save file, the JAX package's msgpack state "
            f"file, reference safetensors)")
    return _Msgpack(buf).value()


# ------------------------------------------------------------- safetensors

SAFETENSORS_DTYPES = {"F32": "float32", "F16": "float16", "BF16": "bfloat16",
                      "I64": "int64", "I32": "int32", "U8": "uint8",
                      "BOOL": "bool"}


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """A safetensors file -> {name: CPU tensor viewing the file's map};
    ``__metadata__`` is skipped."""
    buf = _map_file(path)
    n = int.from_bytes(buf[:8], "little")
    header = json.loads(str(buf[8:8 + n], "utf-8"))
    base = 8 + n
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        if info["dtype"] not in SAFETENSORS_DTYPES:
            raise ValueError(f"{path}: {name} has dtype {info['dtype']}")
        b, e = info["data_offsets"]
        out[name] = _tensor(buf[base + b:base + e],
                            SAFETENSORS_DTYPES[info["dtype"]],
                            tuple(info["shape"]))
    return out


# --------------------------------------------------------------- restoring

def tolerant_restore(target: Dict[str, torch.Tensor],
                     loaded: Dict[str, torch.Tensor], verbose: bool = True):
    """Copy each entry of ``loaded`` whose name and shape match ``target``'s
    (cast to the target's dtype), keep the target's value otherwise.
    Returns (state_dict, stats): ``stats`` lists the target names
    ``missing`` from ``loaded``, those ``mismatched`` in shape, and
    ``loaded``'s names the target has no place for (``unused``)."""
    out, missing, mismatched = {}, [], []
    for k, v in target.items():
        src = loaded.get(k)
        if src is None:
            missing.append(k)
            if verbose:
                print(f"[ckpt] missing key {k} — keeping init")
            out[k] = v
        elif tuple(src.shape) != tuple(v.shape):
            mismatched.append(k)
            if verbose:
                print(f"[ckpt] shape mismatch for {k}: {tuple(src.shape)} "
                      f"vs {tuple(v.shape)} — keeping init")
            out[k] = v
        else:
            out[k] = src.to(v.dtype)
    stats = {"restored": len(target) - len(missing) - len(mismatched),
             "missing": missing, "mismatched": mismatched,
             "unused": sorted(k for k in loaded if k not in target)}
    return out, stats


def params_tree(tree: dict) -> dict:
    """The ``{"params": {...}}`` tree of one model in a msgpack state file:
    a train state's ``params`` entry, a bare ``{"params": ...}`` tree, or
    a tree of the model's modules (wrapped)."""
    if "step" in tree and "params" in tree:
        tree = tree["params"]
    return tree if "params" in tree else {"params": tree}


# the entry of a port state file that holds each model's weights
PORT_ENTRIES = (("VAEModel", "vae"), ("DiTModel", "model"),
                ("PatchDiscriminator", "disc"),
                ("ViTFeatureEncoder", "encoder"))


def _port_weights(state: dict, module: nn.Module) -> Dict[str, torch.Tensor]:
    for cls, key in PORT_ENTRIES:
        if type(module).__name__ == cls and key in state:
            return state[key]
    raise ValueError(f"the port's state file has no weights for "
                     f"{type(module).__name__} (entries {sorted(state)})")


def load_torch(path: str) -> dict:
    """A port state file, on the CPU."""
    return torch.load(path, map_location="cpu", weights_only=True)


def port_entries(path: str) -> List[str]:
    """The ``PORT_ENTRIES`` weights a port state file holds; [] for any
    other file, a torchscript archive or a plain ``state_dict`` in
    ``torch.save``'s format included."""
    if sniff_format(path) != "torch":
        return []
    with zipfile.ZipFile(path) as z:
        if any(n.endswith("/constants.pkl") for n in z.namelist()):
            return []                       # torchscript
    state = torch.load(path, map_location="cpu", weights_only=True,
                       mmap=True)
    if not isinstance(state, dict):
        return []
    return [key for _, key in PORT_ENTRIES if isinstance(state.get(key), dict)]


def load_params_any(path: str, module: nn.Module, cfg,
                    verbose: bool = True):
    """``module``'s parameters from a file in any of the three formats, as
    (state_dict, stats) of ``tolerant_restore`` against
    ``module.state_dict()``:

    * safetensors: the model family from the names (``autoencoder.`` a
      VAE, ``main.`` a discriminator, else a DiT), mapped by
      ``convert.from_reference``;
    * msgpack: the model's parameter tree (``params_tree``) through
      ``convert.py``'s Flax-path map (a decode-only VAE takes the decode
      side of a whole VAE's tree);
    * torch: the port's state file (its ``vae`` / ``model`` / ``disc`` /
      ``encoder`` entry).
    """
    fmt = sniff_format(path)
    if fmt == "safetensors":
        loaded, unmapped = convert.from_reference(read_safetensors(path),
                                                  module)
        if verbose and unmapped:
            print(f"[ckpt] {len(unmapped)} unmapped names in {path} "
                  f"(first: {unmapped[:5]})")
    elif fmt == "torch":
        loaded = _port_weights(load_torch(path), module)
    else:
        loaded = convert.map_tree(params_tree(read_msgpack(path)),
                                  convert.key_map_for(module, cfg))
    sd, stats = tolerant_restore(module.state_dict(), loaded, verbose)
    if verbose:
        print(f"[ckpt] {path} ({fmt}) -> {type(module).__name__}: "
              f"{stats['restored']} restored, {len(stats['missing'])} "
              f"missing, {len(stats['mismatched'])} mismatched", flush=True)
    return sd, stats


# ------------------------------------------------------ trainer state parts

def save_torch(path: str, state: dict):
    """``torch.save`` to ``path`` atomically (a temporary file, then a
    rename)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    torch.save(state, tmp)
    os.replace(tmp, path)


def rank_state(mesh, generator: torch.Generator, *partial) -> dict:
    """The per-rank part of a trainer's state file, gathered over the
    ranks (every rank calls it): each rank's generator state, indexed by
    rank, and the mesh shape. The gradient sums of a partial accumulation
    (lists from :func:`partial_grads`, or None) are averaged over the
    ranks in place: a run resumed on any number of ranks then all-reduces
    the mean of every rank's sums with its own last micro-step's."""
    for grads in partial:
        for g in grads or ():
            if g is not None:
                mesh.all_reduce_(g).div_(mesh.world)
    return {"generators": mesh.gather(generator.get_state()),
            "mesh_shape": mesh.shape}


def restore_generator_(generator: torch.Generator, state: dict, mesh,
                       seed: int):
    """This rank's generator from a state file: its own saved state when
    the file holds one per rank of this world (a single-process file holds
    ``generator``); else re-seeded from (``seed``, data index, step),
    which it prints."""
    states = state.get("generators") or [state["generator"]]
    if len(states) == mesh.world:
        generator.set_state(states[mesh.rank])
        return
    generator.manual_seed(rank_seed(seed, mesh.data_index,
                                    int(state["step"])))
    if mesh.rank == 0:
        print(f"[ckpt] the state file holds {len(states)} rank(s)' "
              f"generators, this run {mesh.world}: generators re-seeded "
              f"from (seed, data index, step {int(state['step'])})",
              flush=True)


def partial_grads(params: Iterable[torch.Tensor], micro: int,
                  k: int) -> Optional[List[Optional[torch.Tensor]]]:
    """The gradient sums of a partial accumulation (``micro % k`` micro-steps
    taken since the last update), else None."""
    if micro % k == 0:
        return None
    return [p.grad for p in params]


def restore_grads_(params: Iterable[torch.Tensor], grads):
    """Put saved gradient sums back (None clears them)."""
    params = list(params)
    grads = grads if grads is not None else [None] * len(params)
    for p, g in zip(params, grads, strict=True):
        p.grad = None if g is None else g.to(p.device, p.dtype)


def optimizer_parts(opt_state: dict):
    """(AdamW's {count, mu, nu}, micro-steps taken, accumulated gradient
    mean or None) of a msgpack state file's optimizer state: clip + AdamW,
    under gradient accumulation when it holds ``inner_opt_state``."""
    mini, acc = 0, None
    if "inner_opt_state" in opt_state:
        mini, acc = int(opt_state["mini_step"]), opt_state["acc_grads"]
        opt_state = opt_state["inner_opt_state"]

    def find(node):
        if isinstance(node, dict):
            if {"count", "mu", "nu"} <= node.keys():
                return node
            for v in node.values():
                found = find(v)
                if found is not None:
                    return found
        return None

    adam = find(opt_state)
    if adam is None:
        raise ValueError("no AdamW state in the optimizer state")
    return adam, mini, acc


def load_adamw_(opt: torch.optim.Optimizer, moments, count: int):
    """Set ``opt``'s state from per-parameter (first, second) moments in
    parameter order, after ``count`` updates."""
    sd = opt.state_dict()
    sd["state"] = {i: {"step": torch.tensor(float(count)), "exp_avg": m,
                       "exp_avg_sq": v}
                   for i, (m, v) in enumerate(moments)}
    opt.load_state_dict(sd)


def tree_params(module: nn.Module, tree: dict, key_map,
                fill: str = "zeros") -> List[torch.Tensor]:
    """A parameter-shaped tree of a msgpack state file (weights, Adam
    moments or accumulated gradients) as tensors in ``module``'s parameter
    order, through ``key_map`` (``convert.py``); what the tree lacks is the
    module's weight (``fill="weights"``) or zero, as ``tolerant_restore``
    reports."""
    named = list(module.named_parameters())
    target = {n: p.detach() if fill == "weights" else torch.zeros_like(p)
              for n, p in named}
    sd, _ = tolerant_restore(target, convert.map_tree(tree, key_map))
    return [sd[n] for n, _ in named]


def copy_params_(params: Iterable[torch.Tensor], values):
    with torch.no_grad():
        for p, v in zip(params, values, strict=True):
            p.copy_(v)

