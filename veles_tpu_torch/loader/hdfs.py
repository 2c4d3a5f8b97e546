"""HDFS-backed loader (``veles_tpu/loader/hdfs.py``).

Speaks WebHDFS over plain HTTP (the standard library only: no Hadoop
client) to a namenode given as ``namenode=host:port``, and raises a
clear error without one. The surface is
:class:`~veles_tpu_torch.loader.pickles.PicklesLoader`'s: test,
validation and train object paths, each a pickled ``(data, labels)``
tuple (or ``data`` alone), fetched with ``op=OPEN`` and assembled into a
full batch by :meth:`FullBatchLoader.load_class_files`.

The bytes are unpickled as the JAX loader unpickles them: a namenode is
trusted as a local file is, so point the loader only at one you run.
"""

import json
import pickle
import urllib.error
import urllib.parse
import urllib.request

from veles_tpu_torch.loader.fullbatch import FullBatchLoader


class WebHDFSClient(object):
    """Minimal WebHDFS reader: ``OPEN`` and ``GETFILESTATUS``."""

    def __init__(self, namenode, user=None, timeout=30.0):
        if "://" not in namenode:
            namenode = "http://" + namenode
        self.base = namenode.rstrip("/") + "/webhdfs/v1"
        self.user = user
        self.timeout = timeout

    def _url(self, path, op):
        if not path.startswith("/"):
            path = "/" + path
        url = "%s%s?op=%s" % (self.base, urllib.parse.quote(path), op)
        if self.user:
            url += "&user.name=" + urllib.parse.quote(self.user, safe="")
        return url

    def status(self, path):
        with urllib.request.urlopen(self._url(path, "GETFILESTATUS"),
                                    timeout=self.timeout) as resp:
            return json.loads(resp.read())["FileStatus"]

    def read(self, path):
        with urllib.request.urlopen(self._url(path, "OPEN"),
                                    timeout=self.timeout) as resp:
            return resp.read()


class HDFSLoader(FullBatchLoader):
    """Pickled class files fetched from HDFS (WebHDFS REST)."""

    MAPPING = "hdfs"

    def __init__(self, namenode=None, user=None, test_path=None,
                 validation_path=None, train_path=None, **kwargs):
        super(HDFSLoader, self).__init__(**kwargs)
        self.namenode = namenode
        self.user = user
        self.test_path = test_path
        self.validation_path = validation_path
        self.train_path = train_path
        self.client = None

    def load_dataset(self):
        if not self.namenode:
            raise RuntimeError(
                "%s needs a namenode=host:port (WebHDFS); no Hadoop "
                "client libraries are bundled -- this loader is gated on "
                "a reachable WebHDFS endpoint" % self.name)
        self.client = WebHDFSClient(self.namenode, user=self.user)

        def reader(path):
            try:
                blob = self.client.read(path)
            except (urllib.error.URLError, OSError) as e:
                raise RuntimeError(
                    "%s: cannot fetch %s from %s: %s" %
                    (self.name, path, self.namenode, e))
            obj = pickle.loads(blob)
            if isinstance(obj, tuple) and len(obj) == 2:
                return obj
            return obj, None

        self.load_class_files(
            (self.test_path, self.validation_path, self.train_path),
            reader, kind="HDFS")
