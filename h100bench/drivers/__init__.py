"""One module per entry of the port that a traffic file can drive; each
defines ``Driver(config, traffic, seed, device)``."""
