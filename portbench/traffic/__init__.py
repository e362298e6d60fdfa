"""The kinds of loop a traffic mix can name (its ``loop`` key), one module
each, each with a ``Loop(entry, mix, gen, device, seed, image_shape)``
that makes its inputs, ``warm()``s every shape it will use, ``run``s the
window into a ``harness.Run``, and hands back its ``answers()``."""
