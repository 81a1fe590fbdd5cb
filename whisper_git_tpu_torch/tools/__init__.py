"""Tools of the port: seeded synthetic scenes and op lists
(`synthetic`), the golden scenes (`goldens`) and the stored-mask font that
stands in for Pillow on the card (`mask_font`), the fixture-scene dumps
(`dump_bundles`), a primed avatar cache (`avatar_fixture`), kernel timing
(`kernel_times`) and the CLI on a pty (`ptydrive`)."""
