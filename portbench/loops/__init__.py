"""The window's drive loops, one module each, named by a traffic mix's
``loop`` key (``harness.py`` lists what a loop module provides)."""
