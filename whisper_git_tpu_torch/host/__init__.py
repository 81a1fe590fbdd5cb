"""Host side of the port: the headless screenshot CLI."""
