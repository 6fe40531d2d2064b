"""Write a file so that it appears whole or not at all, from any number of
writers at once.

``replacing(path)`` hands its caller a fresh temporary file beside ``path``
(``tempfile.mkstemp`` in the same directory, so the final ``os.replace``
is a rename within one file system) whose name no other writer holds, and
moves it onto ``path`` when the block ends without an error; on an error it
removes the file. A fixed temporary name (``path + ".tmp"``) is shared by
every writer of one path: two of them at once write one file, and the first
``os.replace`` moves the other's half-written file or leaves it none. The
file gets the mode a plain ``open(path, "w")`` would give it.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
from typing import Iterator


def _read_umask() -> int:
    """This process's umask: from ``/proc/self/status`` where there is one,
    else by setting it and setting it back (at import, before any writer)."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("Umask:"):
                    return int(line.split()[1], 8)
    except (OSError, ValueError):
        pass
    mask = os.umask(0o022)
    os.umask(mask)
    return mask


_MODE = 0o666 & ~_read_umask()


@contextlib.contextmanager
def replacing(path: str, suffix: str = ".tmp") -> Iterator[str]:
    """Yield the path of a new empty file in ``path``'s directory, named
    after ``path`` and ending in ``suffix`` (``np.savez`` and ``np.save``
    keep a name that ends in ``.npz`` or ``.npy``); replace ``path`` with it
    when the block succeeds, remove it when the block raises."""
    directory = os.path.dirname(path) or "."
    fd, tmp = tempfile.mkstemp(prefix=f".{os.path.basename(path)}.", suffix=suffix,
                               dir=directory)
    try:
        os.fchmod(fd, _MODE)
    finally:
        os.close(fd)
    try:
        yield tmp
        os.replace(tmp, path)
    except BaseException:
        with contextlib.suppress(OSError):
            os.unlink(tmp)
        raise
