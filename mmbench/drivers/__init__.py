"""The drivers: each runs one kind of traffic mix against the program."""
