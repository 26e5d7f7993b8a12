"""Checkpoint and resume (PyTorch twin of
``fluidsimulationcuda_tpu.utils.checkpoint``).

The file is the JAX package's: an ``.npz`` of the state fields (float32
bits as they are) and ``_meta``, the JSON of ``{"version", "config",
"step"}`` as uint8 bytes.  Either package reads what the other writes:

- ``dtype`` is stored by name (``"float32"``, ``"bfloat16"``), as numpy
  names it;
- a bf16 field is stored as JAX's ``np.asarray`` of it saves: its raw 2-byte
  words as a ``|V2`` array (numpy has no bf16).  ``load_checkpoint`` takes
  ``|V2`` fields as the dtype the file's config names.  (JAX's own
  ``load_checkpoint`` raises on such a file: ``jnp.asarray`` refuses
  ``|V2``.);
- ``backend`` is stored in the JAX package's names: the port's ``"cuda"``
  is written as ``"pallas"`` (JAX's ``SimConfig`` refuses ``"cuda"``) and
  ``"pallas"`` is read as ``"cuda"``;
- ``device`` is not part of the file: the caller of ``load_checkpoint``
  says where the state goes.
"""
from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

from ..core.config import SimConfig
from ..core.state import FluidState

__all__ = ["save_checkpoint", "load_checkpoint"]

_FIELDS = ("dens", "u", "v", "w")

# Schema version: bump on layout changes.  Config fields load tolerantly
# whatever the version (unknown keys dropped, missing keys defaulted).
_SCHEMA_VERSION = 1
# The port's backend names against the JAX package's, in the file.
_TO_FILE = {"cuda": "pallas"}
_FROM_FILE = {"pallas": "cuda"}


def save_checkpoint(path: str, state: FluidState, cfg: SimConfig,
                    step: int = 0) -> None:
    """Write ``state``, ``cfg`` and ``step`` to ``path`` atomically (a
    ``.tmp`` file, then ``os.replace``)."""
    arrays = {name: _to_file(getattr(state, name)) for name in _FIELDS
              if getattr(state, name) is not None}
    meta = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
            if f.name != "device"}
    meta["dtype"] = str(cfg.dtype).removeprefix("torch.")
    meta["backend"] = _TO_FILE.get(cfg.backend, cfg.backend)
    payload = dict(arrays)
    payload["_meta"] = np.frombuffer(
        json.dumps({"version": _SCHEMA_VERSION, "config": meta,
                    "step": step}).encode(),
        dtype=np.uint8)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez_compressed(f, **payload)
    os.replace(tmp, path)


def _to_file(t: torch.Tensor) -> np.ndarray:
    """A field as the file holds it: float32 as it is, bf16 as raw 2-byte
    words (``|V2``)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.dtype("V2"))
    return t.numpy()


def _from_file(a: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    """A field from the file: raw 2-byte words are bf16 when the config
    says so."""
    if a.dtype.kind == "V":
        if a.dtype.itemsize != 2 or dtype != torch.bfloat16:
            raise ValueError(f"a {a.dtype} field in a {dtype} checkpoint")
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a)


def config_from_meta(cfg_d: dict, device: torch.device | str) -> SimConfig:
    """The ``SimConfig`` of a checkpoint's ``config`` dict on ``device``:
    keys this build does not know are dropped, missing ones defaulted."""
    cfg_d = dict(cfg_d)
    dtype = getattr(torch, cfg_d.get("dtype", "float32"), None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"unknown dtype {cfg_d['dtype']!r} in checkpoint")
    cfg_d["dtype"] = dtype
    backend = cfg_d.get("backend", "auto")
    cfg_d["backend"] = _FROM_FILE.get(backend, backend)
    known = {f.name for f in dataclasses.fields(SimConfig)} - {"device"}
    return SimConfig(device=device,
                     **{k: v for k, v in cfg_d.items() if k in known})


def load_checkpoint(path: str, device: torch.device | str = "cuda"
                    ) -> tuple[FluidState, SimConfig, int]:
    """``(state, cfg, step)`` from ``path``, the state on ``device`` (the
    card unless the caller asks for ``"cpu"``)."""
    with np.load(path) as z:
        meta = json.loads(bytes(z["_meta"]).decode())
        version = meta.get("version", 0)
        if version > _SCHEMA_VERSION:
            raise ValueError(
                f"checkpoint {path!r} has schema version {version}, newer "
                f"than this build's {_SCHEMA_VERSION}; upgrade the framework")
        cfg = config_from_meta(meta["config"], device)
        fields = {name: _from_file(z[name], cfg.dtype).to(cfg.device)
                  if name in z.files else None for name in _FIELDS}
    return FluidState(**fields), cfg, meta["step"]
