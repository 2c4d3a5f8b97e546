"""The REST-fed inference loader (``veles_tpu/loader/restful.py``).

Pairs with :class:`veles_tpu_torch.restful_api.RESTfulAPI`: each HTTP
request pushes its decoded sample here, the workflow's forward runs, and
the API unit reads the output back. With ``minibatch_size`` above 1,
concurrent requests share one forward; link the API's ``batch_size`` to
this loader's ``minibatch_size`` so that one pass answers all of them::

    loader = RestfulLoader(workflow=wf, sample_shape=(4,), minibatch_size=8)
    api = RESTfulAPI(wf, ...)
    api.link_attrs(loader, ("batch_size", "minibatch_size"))
"""

import numpy

from veles_tpu_torch.loader.interactive import QueueFedLoader


class RestfulLoader(QueueFedLoader):
    """HTTP requests become (possibly coalesced) TEST minibatches."""

    def feed(self, sample):
        """Check the shape here, on the caller's (HTTP) thread: once
        queued, a sample of the wrong size would stop the workflow's
        loop in ``fill_minibatch`` instead of failing its request."""
        sample = numpy.asarray(sample, numpy.float32)
        super(RestfulLoader, self).feed(sample.reshape(self.feed_shape))
