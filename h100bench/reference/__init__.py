"""Plain references the benchmark judges the program against: frozen copies
of the renderer and of the metric arithmetic, importing nothing of the
program."""
