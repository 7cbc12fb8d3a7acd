"""The plain reference the benchmark judges the program by: it imports
nothing of the program."""
