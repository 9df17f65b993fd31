"""Temporary directory management (reference `src/util/TmpDir.{h,cpp}`).

Copied from `stellar_core_tpu/util/tmpdir.py` at commit a7226ae; carry a fix
in either copy to the other.
"""

from __future__ import annotations

import os
import shutil
import tempfile


class TmpDir:
    def __init__(self, prefix: str = "sct", root: str | None = None) -> None:
        if root:
            os.makedirs(root, exist_ok=True)
        self.path = tempfile.mkdtemp(prefix=prefix + "-", dir=root)

    def join(self, *parts: str) -> str:
        return os.path.join(self.path, *parts)

    def remove(self) -> None:
        shutil.rmtree(self.path, ignore_errors=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.remove()
        return False


class TmpDirManager:
    """Owns a root dir of tmpdirs, cleaned on startup (reference
    TmpDirManager role)."""

    def __init__(self, root: str) -> None:
        self.root = root
        shutil.rmtree(root, ignore_errors=True)
        os.makedirs(root, exist_ok=True)

    def tmp_dir(self, prefix: str) -> TmpDir:
        return TmpDir(prefix=prefix, root=self.root)

    def clean(self) -> None:
        shutil.rmtree(self.root, ignore_errors=True)
