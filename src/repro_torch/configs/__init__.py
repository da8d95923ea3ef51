"""Model configurations served by the port (copies of ``repro.configs``)."""
