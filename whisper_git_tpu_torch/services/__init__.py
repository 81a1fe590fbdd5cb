"""Services & persistence (L7): config, recents, token store, crash log,
CI providers, avatars, AI commit messages."""
