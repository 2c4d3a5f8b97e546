"""The single-device functions of ``veles_tpu/parallel`` that the
sequence models compute: attention (``sequence.py``) and the dense
mixture-of-experts FFN (``ep.py``). The sharded schedules over a device
mesh come with the port's parallel tier."""
