"""Coder artifact paths — the file-level part of ``fenix_tpu/coder.py``.

Only what the catalog needs before coders are ported: where a coder's
``.npz`` lives, listing and dropping them. Training, loading and cell
ranking wait for the IVF port (ROADMAP queue 1). Paths are the JAX
package's, so a root serves both packages.
"""

from __future__ import annotations

import glob
import os
from typing import Iterator

from fenix_tpu_torch.io import table

LOCATION: str = "codings"


def path_of(root: str, name: str) -> str:
    return table.safe_join(root, LOCATION, name + ".npz")


def list(root: str) -> Iterator[str]:
    base = os.path.join(root, LOCATION)
    for path in sorted(glob.glob(os.path.join(base, "**", "*.npz"), recursive=True)):
        yield os.path.relpath(path, base).removesuffix(".npz")


def drop(root: str, name: str) -> None:
    path = path_of(root, name)
    if os.path.exists(path):
        os.unlink(path)
