"""StandardWorkflow: the training topology from a loader and a ``layers``
list (``veles_tpu/standard_workflow.py``).

Each descriptor is ``{"type": <name>, ...params}`` (the types of
``models.build.LAYER_TYPES``); the constructor wires the JAX package's graph
unit for unit:

    repeater -> loader -> forwards... -> evaluator -> decision
    decision -> gd[k] ... gd[0] -> repeater   (gd gated off non-TRAIN)
    end_point <- decision (gate: decision.complete)

so ``fused_compatible``, ``checksum`` and ``generate_graph`` see the
JAX workflow's topology. After ``initialize()``, :attr:`model` is the
``nn.Sequential`` of the forward units' modules, the model the port's
``FusedTrainer`` trains and ``ServeableModel.from_workflow`` serves.
"""

from torch import nn

from veles_tpu_torch.accelerated_units import AcceleratedWorkflow
from veles_tpu_torch.nn import units
from veles_tpu_torch.nn.decision import DecisionGD, DecisionMSE
from veles_tpu_torch.plumbing import Repeater

#: layer descriptor type -> forward unit class
LAYER_TYPES = {
    "all2all": units.All2All,
    "all2all_tanh": units.All2AllTanh,
    "all2all_relu": units.All2AllRELU,
    "all2all_str": units.All2AllStrictRELU,
    "all2all_sigmoid": units.All2AllSigmoid,
    "softmax": units.All2AllSoftmax,
    "conv": units.Conv,
    "conv_tanh": units.ConvTanh,
    "conv_relu": units.ConvRELU,
    "conv_str": units.ConvStrictRELU,
    "conv_sigmoid": units.ConvSigmoid,
    "deconv": units.Deconv,
    "max_pooling": units.MaxPooling,
    "maxabs_pooling": units.MaxAbsPooling,
    "avg_pooling": units.AvgPooling,
    "depooling": units.Depooling,
    "norm": units.LRNormalizerForward,
    "dropout": units.DropoutForward,
    "activation": units.ActivationUnit,
    "attention": units.MultiHeadAttentionForward,
    "moe": units.MoEForward,
}


class TrainableWorkflow(AcceleratedWorkflow):
    """What ``FusedRunner`` reads from a training workflow: ``loader``,
    ``forwards``, ``evaluator``, ``decision``, ``gds`` (in reverse
    layer order) and the ``model`` of the forward modules."""

    hide_from_registry = True

    #: a uniform source replacing the dropout masks' Philox fill (see
    #: ``train.step.FusedTrainer``); None is the fill
    uniform_source = None

    @property
    def model(self):
        """The ``nn.Sequential`` of the forward units' modules."""
        return nn.Sequential(*[fwd.module for fwd in self.forwards])

    def _link_loader(self, loader):
        loader = loader(self) if callable(loader) else loader
        if loader.workflow is not self:
            loader.workflow = self
        return loader

    def set_testing(self, testing=True):
        """Inference mode: dropout off, no gradients, one forward-only
        epoch (then the decision stops the loop) -- what ``--test``
        runs."""
        self.evaluator.testing = testing
        self.decision.testing = testing
        if testing:
            # a snapshot-resumed workflow arrives with complete=True;
            # the test pass must re-open the loop for one epoch
            self.decision.complete.value = False
        for fwd in self.forwards:
            if isinstance(fwd, units.DropoutForward):
                fwd.testing = testing


class StandardWorkflow(TrainableWorkflow):
    """Canonical training workflow from a loader + layers config."""

    hide_from_registry = True

    def __init__(self, workflow=None, loader=None, layers=(),
                 loss="softmax", learning_rate=0.01, weights_decay=0.0,
                 momentum=0.0, lr_decay=1.0, solver="sgd",
                 max_epochs=None, fail_iterations=100,
                 mse_target_attr="minibatch_data", **kwargs):
        super(StandardWorkflow, self).__init__(workflow, **kwargs)
        if loader is None:
            raise ValueError("StandardWorkflow needs a loader factory")
        self.layers = [dict(d) for d in layers]

        self.repeater = Repeater(self)
        self.repeater.link_from(self.start_point)

        self.loader = self._link_loader(loader)
        self.loader.link_from(self.repeater)

        # -- forward chain -------------------------------------------------
        self.forwards = []
        prev, prev_attr = self.loader, "minibatch_data"
        for i, descr in enumerate(layers):
            descr = dict(descr)
            ltype = descr.pop("type")
            cls = LAYER_TYPES.get(ltype)
            if cls is None:
                raise ValueError("unknown layer type %r (have %s)" %
                                 (ltype, sorted(LAYER_TYPES)))
            lr = descr.pop("learning_rate", learning_rate)
            wd = descr.pop("weights_decay", weights_decay)
            mom = descr.pop("momentum", momentum)
            descr.setdefault("name", "%s%d" % (ltype, i))
            fwd = cls(self, **descr)
            fwd._gd_hyper = dict(learning_rate=lr, weights_decay=wd,
                                 momentum=mom)
            fwd.link_from(prev)
            fwd.link_attrs(prev, ("input", prev_attr))
            self.forwards.append(fwd)
            prev, prev_attr = fwd, "output"

        # -- evaluator + decision ------------------------------------------
        head = self.forwards[-1]
        if loss == "softmax":
            self.evaluator = units.EvaluatorSoftmax(self, name="evaluator")
            self.evaluator.link_attrs(self.loader,
                                      ("labels", "minibatch_labels"))
            self.decision = DecisionGD(self, max_epochs=max_epochs,
                                       fail_iterations=fail_iterations,
                                       name="decision")
            self.decision.link_attrs(self.evaluator,
                                     ("minibatch_n_err", "n_err"))
        elif loss == "mse":
            self.evaluator = units.EvaluatorMSE(self, name="evaluator")
            self.evaluator.link_attrs(self.loader,
                                      ("target", mse_target_attr))
            self.evaluator.link_attrs(self.loader,
                                      ("indices", "minibatch_indices"))
            self.decision = DecisionMSE(self, max_epochs=max_epochs,
                                        fail_iterations=fail_iterations,
                                        name="decision")
            self.decision.link_attrs(self.evaluator,
                                     ("minibatch_mse", "mse_per_sample"))
        else:
            raise ValueError("loss must be softmax or mse")
        self.evaluator.link_from(head)
        self.evaluator.link_attrs(head, "output")
        self.evaluator.link_attrs(self.loader,
                                  ("batch_size", "minibatch_size"))
        self.decision.link_from(self.evaluator)
        self.decision.link_attrs(self.loader, "minibatch_class",
                                 "last_minibatch", "epoch_ended",
                                 "epoch_number", "class_lengths",
                                 "minibatch_size")

        # -- backward chain ------------------------------------------------
        self.gds = []
        err_src, err_attr = self.evaluator, "err_output"
        for fwd in reversed(self.forwards):
            gd_cls = (units.DropoutBackward
                      if isinstance(fwd, units.DropoutForward)
                      else units.GradientDescentBase)
            hyper = fwd._gd_hyper
            gd = gd_cls(self, forward=fwd,
                        learning_rate=hyper["learning_rate"],
                        weights_decay=hyper["weights_decay"],
                        momentum=hyper["momentum"],
                        solver=solver,
                        solver_hp={"lr_decay": lr_decay}
                        if lr_decay != 1.0 else {},
                        need_err_input=fwd is not self.forwards[0],
                        name="gd_" + fwd.name)
            gd.link_from(self.gds[-1] if self.gds else self.decision)
            gd.link_attrs(err_src, ("err_output", err_attr))
            gd.gate_skip = self.decision.gd_skip
            self.gds.append(gd)
            err_src, err_attr = gd, "err_input"

        self.repeater.link_from(self.gds[-1] if self.gds
                                else self.decision)
        self.repeater.gate_block = self.decision.complete
        self.end_point.link_from(self.decision)
        self.end_point.gate_block = ~self.decision.complete
