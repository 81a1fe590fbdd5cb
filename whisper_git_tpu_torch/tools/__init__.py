"""Tools of the port: the atlas export and seeded synthetic scenes."""
