"""The model stack (``model``), its layers and attention, and ``convert``,
which carries the JAX package's weights into the port for the tests."""
