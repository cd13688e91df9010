"""Traffic mixes: one data file a mix (`<mix>.json`), and the scene generator
they draw their maps from (`scene.py`)."""
