"""Plain PyTorch references of the benchmark's model families, in float32
with TF32 off, computed layer by layer so that they fit beside nothing
else on the card.  They import nothing of the port: the sizes come from
the configuration file, the weights and inputs from the benchmark.

A family is ``reference/<name>.py`` (a configuration file names it under
``reference``) with ``block(x, p, c, prec)`` (one layer), ``groups(c)``
(its weights' layout) and ``active_weights(c)`` (one layer's weights a
token passes through)."""
import importlib


def family(c):
    """The family module that configuration ``c`` names."""
    return importlib.import_module(f"{__name__}.{c['reference']}")
