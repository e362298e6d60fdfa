"""Plain references of the benchmark's configurations, one module each.

A module named by a configuration's ``reference`` key gives ``layers(cfg)``
(each layer's shapes and calibration, in the order the weights are drawn)
and ``forward(params, x)`` (float32 logits of u8 images). Nothing here
imports the program under test.
"""
