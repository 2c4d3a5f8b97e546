"""The plotter unit (``veles_tpu/plotter.py``).

A plotter is an ordinary unit of the control-flow graph whose ``run()``
captures its plot data on the host and sends a stripped pickle of
itself to the graphics server; matplotlib renders in the client process
(:mod:`veles_tpu_torch.graphics_client`), never on the training path.
On slaves plotters are skipped: plots describe the master's (or the
standalone run's) state.

Subclasses implement ``fill()``, which reads the linked attributes and
copies every tensor among them to host numpy (``.detach().cpu()``: the
one place a plot waits for the card, once a plot), so a snapshot never
carries a CUDA tensor and unpickles in a process that has no card (the
stripped pickle leaves behind inputs assigned as tensors); and
``redraw(figure)``, pure matplotlib over the captured data.
"""

from veles_tpu_torch.config import root
from veles_tpu_torch.distributable import HostTensor
from veles_tpu_torch.units import Unit


class Plotter(Unit):
    """Base unit of every plotter. See the module docstring."""

    hide_from_registry = True
    view_group = "PLOTTER"

    def __init__(self, workflow, **kwargs):
        kwargs.setdefault("view_group", "PLOTTER")
        super(Plotter, self).__init__(workflow, **kwargs)
        self.clear_plot = kwargs.get("clear_plot", False)
        self.redraw_plot = kwargs.get("redraw_plot", True)
        #: True once fill() captured live data (the publisher must not
        #: fill again a plotter that accumulated state during the run)
        self.has_filled = False
        self.last_figure_ = None

    @property
    def enabled(self):
        if self.is_slave:
            return False
        # headless runs disable plotting by default (config.py), but a
        # live graphics server means renderers subscribed
        if self._find_server() is not None:
            return True
        return not root.common.disable.get("plotting", False)

    def initialize(self, **kwargs):
        pass

    def run(self):
        if not self.enabled:
            return
        self.fill()
        self.has_filled = True
        server = self._find_server()
        if server is not None:
            server.enqueue(self)

    def _find_server(self):
        from veles_tpu_torch.graphics_server import GraphicsServer
        server = getattr(self.launcher, "_graphics_server", None)
        return server if server is not None else GraphicsServer.current

    def __getstate__(self):
        state = super(Plotter, self).__getstate__()
        if self.stripped_pickle:
            # a snapshot carries the captured host data: live inputs that
            # were assigned rather than linked (a tensor, which pickles as
            # a HostTensor, or a list of them: ImmediatePlotter.inputs,
            # TableMaxMin.y) stay behind
            for key, value in list(state.items()):
                items = value if isinstance(value, (list, tuple)) \
                    else (value,)
                if any(isinstance(v, HostTensor) for v in items):
                    state[key] = None
        return state

    def fill(self):
        """Capture plot data from linked attributes into plain fields."""

    def redraw(self, figure):
        """Render the captured data onto ``figure`` (client side)."""
        raise NotImplementedError
