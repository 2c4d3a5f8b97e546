"""The directory-tree scanner of the file-backed loaders
(``veles_tpu/loader/file_scanner.py``).

Collects ``(path, label_name)`` pairs whose label is the name of the
file's parent directory, in a deterministic order; the image and sound
loaders scan with their own extension sets.
"""

import os
import re


class LabeledFileScanner(object):
    """Recursive scan filtered by extension and an optional file-name
    regex; ``ignored_dirs`` are pruned from the walk."""

    def __init__(self, extensions, ignored_dirs=(), filename_re=None):
        self.extensions = tuple(ext.lower() for ext in extensions)
        self.ignored_dirs = set(ignored_dirs)
        self.filename_re = re.compile(filename_re) if filename_re else None

    def scan(self, base):
        if os.path.isfile(base):
            return [(base, os.path.basename(
                os.path.dirname(os.path.abspath(base))))]
        found = []
        # pruning through dirnames[:] works on the live walk only
        for dirpath, dirnames, filenames in os.walk(base):
            dirnames[:] = sorted(d for d in dirnames
                                 if d not in self.ignored_dirs)
            for name in sorted(filenames):
                if not name.lower().endswith(self.extensions):
                    continue
                if self.filename_re and not self.filename_re.search(name):
                    continue
                found.append((os.path.join(dirpath, name),
                              os.path.basename(dirpath)))
        found.sort()
        return found
