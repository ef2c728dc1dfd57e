"""Tokenizer, grammar DFA, inference engine and local decision backend."""
