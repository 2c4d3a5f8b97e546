"""Dataset downloader unit (``veles_tpu/downloader.py``).

At ``initialize()``, unless every file of ``files`` is already under
``directory``, the unit fetches ``url`` and unpacks it there: a
``file://`` (or plain path) URL is read in place, an ``http(s)://`` one
is streamed to ``directory`` first and removed after unpacking. A
``.zip`` or ``.tar*`` archive is unpacked (tar members through the
``data`` filter: no absolute paths, no links out of the directory); any
other file is the dataset itself, copied into ``directory`` (a
downloaded one is already there and stays: the JAX unit copies it onto
itself and fails). An archive that does not provide every
promised file raises ``FileNotFoundError``. Link the unit ahead of the
loader that reads the files, or just build it first: it does all its
work in ``initialize()``, before the loader loads.
"""

import os
import shutil
import tarfile
import urllib.parse
import urllib.request
import zipfile

from veles_tpu_torch.config import root
from veles_tpu_torch.units import TrivialUnit


class Downloader(TrivialUnit):
    """Fetch and unpack a dataset archive if it is not there yet."""

    view_group = "SERVICE"

    def __init__(self, workflow, **kwargs):
        self.url = kwargs.pop("url")
        self.directory = kwargs.pop(
            "directory", root.common.dirs.get("datasets", "."))
        #: files whose presence means the dataset is already there
        self.files = tuple(kwargs.pop("files", ()))
        super(Downloader, self).__init__(workflow, **kwargs)

    def initialize(self, **kwargs):
        if self.files and all(
                os.path.exists(os.path.join(self.directory, name))
                for name in self.files):
            self.debug("dataset already present in %s", self.directory)
            return
        os.makedirs(self.directory, exist_ok=True)
        archive = self._fetch()
        fetched = archive.startswith(self.directory)
        kept = False
        try:
            kept = self._unpack(archive, fetched)
        finally:
            if fetched and not kept:
                os.unlink(archive)
        missing = [name for name in self.files if not os.path.exists(
            os.path.join(self.directory, name))]
        if missing:
            raise FileNotFoundError(
                "archive from %s did not provide: %s" %
                (self.url, ", ".join(missing)))

    def _fetch(self):
        """The archive's local path: the file itself for ``file://``, a
        download into ``directory`` otherwise."""
        parsed = urllib.parse.urlparse(self.url)
        if parsed.scheme in ("", "file"):
            return urllib.request.url2pathname(parsed.path)
        target = os.path.join(self.directory, os.path.basename(parsed.path))
        self.info("downloading %s", self.url)
        with urllib.request.urlopen(self.url) as response, \
                open(target, "wb") as out:
            shutil.copyfileobj(response, out, 1 << 20)
        return target

    def _unpack(self, archive, fetched):
        """Unpack ``archive`` into ``directory``; True when it is a plain
        file that stays where it is (``fetched`` into the directory)."""
        self.info("unpacking %s to %s", archive, self.directory)
        if zipfile.is_zipfile(archive):
            with zipfile.ZipFile(archive) as z:
                z.extractall(self.directory)
        elif tarfile.is_tarfile(archive):
            with tarfile.open(archive) as t:
                t.extractall(self.directory, filter="data")
        elif fetched:
            return True
        else:
            shutil.copy(archive, self.directory)
        return False
