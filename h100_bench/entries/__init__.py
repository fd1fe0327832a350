"""One module a kind of cell: ``run(ctx)`` drives the program and returns the result."""
