"""Forge: the model repository (``veles_tpu/forge/``).

A :class:`ForgeServer` stores versioned model packages (a workflow file,
a config file, the export's members, described by a ``manifest.json``)
and answers ``/forge?query=list|details|delete``,
``/fetch?name=&version=`` and ``POST /upload``; versions are directory
snapshots with an upload journal, and a shared token guards the
changes. :class:`ForgeClient` is its client. Both speak the JAX
package's protocol, so either package's client talks to either's server.
"""

from veles_tpu_torch.forge.client import ForgeClient  # noqa: F401
from veles_tpu_torch.forge.server import ForgeServer  # noqa: F401
