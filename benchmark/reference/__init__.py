"""The plain references the benchmark holds the program to. Plain
PyTorch and numpy only: nothing here imports the program, ``jax`` or
``heal_tpu``. ``<config>.py`` is the reference of one configuration; its
``build(hypes)`` returns the model, whose state-dict names are the
port's, so one set of seeded weights loads into both."""
