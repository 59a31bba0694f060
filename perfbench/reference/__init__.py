"""The plain references and the comparisons that decide correct."""
