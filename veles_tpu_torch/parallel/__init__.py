"""The port's ``veles_tpu/parallel``: the master/slave control plane
(``coordinator.py``, its codec ``wire.py``, ``retry.py``, the node
spawner ``nodes.py``) and the single-device functions the sequence
models compute -- attention (``sequence.py``) and the dense
mixture-of-experts FFN (``ep.py``). The sharded schedules over a device
mesh come with the port's ``torch.distributed`` tier."""
