"""Training of the port's Llama: the single-device train step
(``train.py``) and its command-line launcher (``main.py``)."""
