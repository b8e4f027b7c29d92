"""The port's CSDL-alpha adapters (`models`)."""
