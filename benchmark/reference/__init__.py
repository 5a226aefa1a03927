"""The plain reference the benchmark holds the port against: plain PyTorch,
float32, importing nothing of the port (``model.py``, ``loss.py``,
``train.py``; the controls' rounding in ``precision.py``)."""
