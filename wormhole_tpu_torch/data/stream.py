"""URI-addressed byte streams, local files only.

The part of ``wormhole_tpu/data/stream.py`` the port needs: ``open_stream``
for local paths (``file://`` or bare), ``get_filesystem`` (the local file
system the input splits read through), ``list_files`` with the reference
WorkloadPool's ListDirectory + regex match (``workload_pool.h:46-66``), and
``discard_output`` for writers that fail mid-write. Remote schemes
(``s3://``, ``hdfs://``, ``webhdfs://``) are not ported yet and raise.
"""

from __future__ import annotations

import glob as _glob
import os
import re
from typing import List


class FileInfo:
    __slots__ = ("path", "size")

    def __init__(self, path: str, size: int) -> None:
        self.path = path
        self.size = size

    def __repr__(self) -> str:
        return f"FileInfo({self.path!r}, {self.size})"


def _local_path(uri: str) -> str:
    m = re.match(r"^([a-zA-Z][a-zA-Z0-9+.-]*)://", uri)
    if not m:
        return uri
    if m.group(1) != "file":
        raise ValueError(f"{uri}: scheme {m.group(1)!r} is not ported yet "
                         "(local files only; see ROADMAP.md)")
    return uri[len("file://"):]


def open_stream(uri: str, mode: str = "rb"):
    """dmlc ``Stream::Create`` equivalent for local files; write modes
    create the parent directory."""
    path = _local_path(uri)
    if "w" in mode or "a" in mode:
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
    return open(path, mode)


class LocalFileSystem:
    """The one file system of the port: ``open`` over local paths (the
    JAX package's ``LocalFileSystem``, which the input splits read
    through)."""

    def open(self, uri: str, mode: str = "rb"):
        return open_stream(uri, mode)


_LOCAL = LocalFileSystem()


def get_filesystem(uri: str) -> LocalFileSystem:
    """The file system that serves ``uri``: the local one, for a bare path
    or ``file://``; any other scheme raises (not ported yet)."""
    _local_path(uri)
    return _LOCAL


def _list_directory(path: str) -> List[FileInfo]:
    if os.path.isdir(path):
        names = [os.path.join(path, n) for n in sorted(os.listdir(path))]
    else:
        names = sorted(_glob.glob(path))
    return [FileInfo(n, os.path.getsize(n)) for n in names
            if os.path.isfile(n)]


def list_files(pattern: str) -> List[FileInfo]:
    """List files matching a path/glob/regex: the final path component is
    treated as a regex if the plain listing finds nothing."""
    path = _local_path(pattern)
    found = _list_directory(path)
    if found:
        return found
    head, _, tail = path.rpartition("/")
    if head and tail:
        try:
            rx = re.compile(tail)
        except re.error:
            return []
        return [fi for fi in _list_directory(head)
                if rx.search(os.path.basename(fi.path))]
    return []


def discard_output(f) -> None:
    """Writer error-path helper: truncate a partially-written local file
    to zero bytes, so a later reader fails the header parse loudly instead
    of consuming a silently shorter dataset."""
    try:
        f.seek(0)
        f.truncate(0)
    except (OSError, ValueError):
        pass
