"""The decode cache: a fixture decoded and put into the program's device
layout once, then loaded from `portbench/.cache/` by every later run in
the same checkout.

An entry is keyed by the fixture file's bytes, the driver's own
parameters and the program's Python sources, so a changed program or
fixture never reads a stale entry. Entries hold CPU tensors inside the
program's own dataclasses (torch.save); `load` moves them to the device.
Only this module writes the directory, and it reads back only what it
wrote.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import pathlib
from typing import Any, Callable

import torch


def tree_map(fn: Callable[[torch.Tensor], torch.Tensor], obj: Any) -> Any:
    """`fn` applied to every tensor inside dataclasses, dicts, lists and
    tuples (frozen dataclasses, the program's field and curve constants,
    are left as they are)."""
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type) and not obj.__dataclass_params__.frozen:
        return dataclasses.replace(obj, **{f.name: tree_map(fn, getattr(obj, f.name))
                                           for f in dataclasses.fields(obj) if f.init})
    if isinstance(obj, dict):
        return {k: tree_map(fn, v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(tree_map(fn, v) for v in obj)
    return obj


def _digest(paths: list[pathlib.Path], extra: dict) -> str:
    h = hashlib.sha256(json.dumps(extra, sort_keys=True).encode())
    for p in paths:
        h.update(str(p.name).encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:20]


class DecodeCache:
    def __init__(self, directory: pathlib.Path, program_dir: pathlib.Path):
        self.dir = pathlib.Path(directory)
        self.program_sources = sorted(pathlib.Path(program_dir).rglob("*.py"))

    def get(self, kind: str, fixture: pathlib.Path, params: dict, build: Callable[[], Any], device) -> tuple[Any, bool]:
        """(the entry on `device`, whether it came from the cache). `build`
        returns the entry (its tensors anywhere) when there is none."""
        key = _digest([pathlib.Path(fixture), *self.program_sources], {"kind": kind, **params})
        path = self.dir / f"{kind}-{key}.pt"
        if path.exists():
            obj = torch.load(path, map_location="cpu", weights_only=False)
            return tree_map(lambda t: t.to(device), obj), True
        obj = build()
        self.dir.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(f".{path.name}.{os.getpid()}")
        torch.save(tree_map(lambda t: t.detach().cpu(), obj), tmp)
        os.replace(tmp, path)
        return tree_map(lambda t: t.to(device), obj), False
