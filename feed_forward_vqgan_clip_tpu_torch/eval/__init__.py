"""Offline evaluation: CLIP score and FID over a prompt set."""
