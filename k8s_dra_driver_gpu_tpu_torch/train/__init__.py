"""Training of the port's Llama: the train step, single-device, sharded
and K steps a call (``train.py``), its gang launcher (``main.py``), and
the workload's side of the cooperative migration contract
(``cooperative.py``)."""
