"""Validation Gate (paper §3.5, Eq. 2).

A side thought is merged only if the cosine similarity between its terminal
hidden state and the main agent's current hidden state clears a threshold
theta (paper default 0.5).
"""
from __future__ import annotations

import torch


def cosine_score(h_main, t_side, eps: float = 1e-8):
    """Eq. 2: h_main, t_side: [B, d] -> [B] f32."""
    a = h_main.float()
    b = t_side.float()
    num = (a * b).sum(dim=-1)
    den = torch.linalg.vector_norm(a, dim=-1) * torch.linalg.vector_norm(b, dim=-1) + eps
    return num / den


def validate(h_main, t_side, theta: float = 0.5):
    """Returns (accept [B] bool, score [B] f32)."""
    score = cosine_score(h_main, t_side)
    return score >= theta, score
