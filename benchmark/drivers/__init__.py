"""Ways of driving the port: one module per driver, named by a traffic
mix's ``driver`` key, each with a ``Driver(cell, seed, device)`` that has
``setup()``, ``window(seconds, trace)``, ``release()`` (the program's state),
``check(rounding=None)`` and ``close()`` (what the checks kept)."""
