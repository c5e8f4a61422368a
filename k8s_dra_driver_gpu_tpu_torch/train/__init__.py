"""Training of the port's Llama: the train step, single-device, sharded
and K steps a call (``train.py``), and its gang launcher (``main.py``)."""
