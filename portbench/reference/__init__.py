"""The plain reference the benchmark holds the port to: PyTorch and numpy
only, importing nothing of ``jax``, ``mvkpconv_tpu`` or
``mvkpconv_tpu_torch``. ``model.py`` is the network, ``geometry.py`` the
pyramid and the pixel association, ``unet.py`` the 2D network."""
