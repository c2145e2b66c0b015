"""The plain reference the benchmark holds the served tokens against. It
imports torch alone: nothing of the program under test."""
