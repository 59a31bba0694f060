"""The harness: finding a cell, its rows, its window, its trace."""
