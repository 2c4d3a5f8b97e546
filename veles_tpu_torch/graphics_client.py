"""The rendering client of the graphics server
(``veles_tpu/graphics_client.py``).

    python -m veles_tpu_torch.graphics_client --endpoint tcp://HOST:PORT \\
        [--mode png|pdf|show] [--out DIR] [--backend NAME]

A process of its own subscribes to the server
(:mod:`veles_tpu_torch.graphics_server`), unpickles plotter snapshots
and renders them with matplotlib: ``show`` in a window, ``png`` /
``pdf`` as one file a plotter name in ``--out``, overwritten on each
snapshot, so the directory holds the latest state. It runs on the CPU:
a snapshot holds host arrays only.
"""

import argparse
import os
import pickle
import zlib

from veles_tpu_torch.graphics_server import TOPIC_END, Subscription
from veles_tpu_torch.logger import Logger


class GraphicsClient(Logger):
    """A subscriber that renders plotter snapshots."""

    def __init__(self, endpoint, mode="png", out=None, backend=None,
                 **kwargs):
        super(GraphicsClient, self).__init__(**kwargs)
        self.endpoint = endpoint
        self.mode = mode
        self.out = out or os.getcwd()
        #: the snapshots rendered
        self.rendered = 0
        import matplotlib
        if backend:
            # use() checks the name only: the pyplot import loads the
            # backend (and raises for one whose toolkit is missing), so
            # it sits inside the try for the fallback to mean anything
            try:
                matplotlib.use(backend, force=True)
                import matplotlib.pyplot  # noqa: F401
            except (ImportError, ValueError) as exc:
                self.warning("backend %r not loadable (%s); "
                             "falling back to Agg", backend, exc)
                matplotlib.use("Agg", force=True)
        elif mode != "show":
            matplotlib.use("Agg")
        self.subscription = Subscription(endpoint)

    def run(self):
        """Receive and render until the ``end`` topic arrives."""
        while self.serve_one():
            pass

    def serve_one(self, timeout=None):
        """Render one snapshot; False when the stream ended (True also
        when ``timeout`` seconds passed with none)."""
        message = self.subscription.get(timeout)
        if message is None:
            return True
        topic, payload = message
        if topic == TOPIC_END:
            return False
        self.render(pickle.loads(zlib.decompress(payload)))
        return True

    def render(self, plotter):
        import matplotlib.pyplot as pp
        figure = pp.figure(plotter.name)
        figure.clf()
        try:
            plotter.redraw(figure)
        except Exception as exc:  # a bad plot must not kill the client
            self.warning("redraw of %s failed: %s", plotter.name, exc)
            pp.close(figure)
            return None
        self.rendered += 1
        if self.mode == "show":
            figure.show()
            pp.pause(0.001)
        else:
            name = "".join(c if c.isalnum() or c in "-_" else "_"
                           for c in plotter.name)
            path = os.path.join(self.out, "%s.%s" % (name, self.mode))
            figure.savefig(path)
            pp.close(figure)
        return figure

    def close(self):
        self.subscription.close()


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--endpoint", required=True)
    parser.add_argument("--mode", default="png",
                        choices=("show", "png", "pdf"))
    parser.add_argument("--out", default=None)
    parser.add_argument("--backend", default=None,
                        help="matplotlib backend (e.g. TkAgg, WebAgg); "
                             "falls back to Agg when not loadable")
    args = parser.parse_args(argv)
    client = GraphicsClient(args.endpoint, mode=args.mode, out=args.out,
                            backend=args.backend)
    try:
        client.run()
    finally:
        client.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
