"""Eval-only orchestration (``evaluate_only``); training waits."""
