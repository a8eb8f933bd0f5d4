"""One driver module per traffic kind, each with run(cell, ...)."""
