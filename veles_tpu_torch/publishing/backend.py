"""The publishing backends' base and registry
(``veles_tpu/publishing/backend.py``)."""

from veles_tpu_torch.logger import Logger


class PublishingBackendRegistry(type):
    """Metaclass: classes with a ``MAPPING`` land in ``backends``."""

    backends = {}

    def __init__(cls, name, bases, namespace):
        super(PublishingBackendRegistry, cls).__init__(
            name, bases, namespace)
        mapping = namespace.get("MAPPING")
        if mapping:
            PublishingBackendRegistry.backends[mapping] = cls


class Backend(Logger, metaclass=PublishingBackendRegistry):
    """One way of rendering the gathered run info."""

    def __init__(self, **kwargs):
        super(Backend, self).__init__()

    def render(self, info):
        raise NotImplementedError
