"""Host side of the port: the interactive terminal loop, its presenter,
and the headless screenshot CLI."""
