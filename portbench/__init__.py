"""The benchmark of the PyTorch/CUDA port: run ``python3 portbench/run.py
--workload <cell> --seed <n> --seconds <s> --trace <0|1>`` from the
checkout's root (see ``run.py``)."""
