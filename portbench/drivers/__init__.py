"""The code that runs each kind of configuration, named by its
``driver``."""
