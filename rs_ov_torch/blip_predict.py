"""Single-image BLIP predictor on the port (tools/blip_predict.py; the
reference's BLIP/predict.py): captioning (384² caption decoder), visual
question answering (480² VQA model, 'generate' inference) and image-text
matching (384² ITM model: the match probability and the ITC cosine), with
the same tasks and output strings.

    python -m rs_ov_torch.blip_predict --task image_captioning \\
        --image photo.jpg --pretrained model_base_caption.pth --vocab vocab.txt
    python -m rs_ov_torch.blip_predict --task visual_question_answering \\
        --image photo.jpg --question "where is the dog?" --pretrained ...
    python -m rs_ov_torch.blip_predict --task image_text_matching \\
        --image photo.jpg --caption "a dog on grass" --pretrained ...

It runs on the card unless ``--device`` names another. ``--tiny
--random-init`` runs the whole flow on random weights at 32² (the smoke
test; ``--device cpu`` without a card).
"""

from __future__ import annotations

import argparse
import sys
import tempfile

import numpy as np
import torch

TASKS = ("image_captioning", "visual_question_answering", "image_text_matching")
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--task", choices=TASKS, default="image_captioning")
    ap.add_argument("--image", required=True)
    ap.add_argument("--question", default=None)
    ap.add_argument("--caption", default=None)
    ap.add_argument("--pretrained", default=None, help="BLIP .pth checkpoint for the task")
    ap.add_argument("--vocab", default=None, help="WordPiece vocab.txt")
    ap.add_argument("--vit", choices=("base", "large"), default="base")
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--random-init", action="store_true", help="skip the checkpoint (smoke)")
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    return ap.parse_args(argv)


def _load_rgb(path: str, size: int) -> np.ndarray:
    """Squash-resize to size² (bicubic), CLIP mean / std: [1, 3, S, S]."""
    from rs_ov_torch.data.transforms import load_image
    from rs_ov_torch.utils.resize import resize_bicubic

    x = np.asarray(load_image(path), np.float32) / 255.0
    x = resize_bicubic(torch.from_numpy(x.transpose(2, 0, 1).copy()), (size, size)).numpy()
    mean, std = np.asarray(CLIP_MEAN, np.float32), np.asarray(CLIP_STD, np.float32)
    return ((x - mean[:, None, None]) / std[:, None, None])[None]


def main(argv=None) -> str:
    args = parse_args(argv)
    if args.task == "visual_question_answering" and not args.question:
        sys.exit("Please type a question for visual question answering task.")
    if args.task == "image_text_matching" and not args.caption:
        sys.exit("Please type a caption for image text matching task.")
    if not args.random_init and not args.pretrained:
        sys.exit("pass --pretrained <ckpt.pth> (or --random-init for smoke)")

    from rs_ov_torch.factory import resolve_device
    from rs_ov_torch.nn import blip, blip_lm
    from rs_ov_torch.nn.bert import BertConfig
    from rs_ov_torch.nn.blip_vit import BlipVisionConfig
    from rs_ov_torch.text.wordpiece import WordPieceTokenizer, write_synthetic_vocab

    device = resolve_device(args.device)
    # 480² for VQA, 384² otherwise (the reference's predict.py)
    size = 32 if args.tiny else (480 if args.task == "visual_question_answering" else 384)
    if args.tiny:
        cfg = blip.BlipConfig(
            vision=BlipVisionConfig(image_size=32, patch_size=16, width=64, layers=2, heads=2),
            text=BertConfig(vocab_size=64, hidden_size=64, num_layers=2, num_heads=2,
                            intermediate_size=128, max_position_embeddings=40),
            embed_dim=32)
    else:
        cfg = (blip.BlipConfig.large if args.vit == "large" else blip.BlipConfig.base)(
            image_size=size)
    if args.vocab:
        tok = WordPieceTokenizer(args.vocab)
    elif args.tiny:  # the decoder's vocabulary less [DEC] and [ENC]
        with tempfile.TemporaryDirectory() as tmp:
            tok = WordPieceTokenizer(write_synthetic_vocab(f"{tmp}/vocab.txt",
                                                           cfg.text.vocab_size - 2))
    else:
        sys.exit("pass --vocab vocab.txt (bert-base-uncased vocabulary)")

    gen = torch.Generator().manual_seed(0)
    img = torch.from_numpy(_load_rgb(args.image, size)).to(device)
    sd = None
    if args.pretrained and not args.random_init:
        from rs_ov_torch.core.checkpoint import load_torch_state_dict

        sd = load_torch_state_dict(args.pretrained)

    if args.task == "image_captioning":
        params = (blip_lm.blip_decoder_params_from_state_dict(sd) if sd is not None
                  else blip_lm.init_blip_decoder_params(gen, cfg)).to(device)
        cap = blip_lm.generate_captions(params, img, cfg, tok, sample=False, num_beams=3,
                                        max_length=20, min_length=5)
        out = "Caption: " + cap[0]
    elif args.task == "visual_question_answering":
        params = (blip_lm.blip_vqa_params_from_state_dict(sd) if sd is not None
                  else blip_lm.init_blip_vqa_params(gen, cfg)).to(device)
        enc = tok([args.question], max_length=35)
        q_ids = enc["input_ids"].astype(np.int32)
        q_ids[:, 0] = tok.enc_token_id
        ans = blip_lm.vqa_generate_answers(params, img, q_ids, enc["attention_mask"], cfg, tok,
                                           num_beams=3, max_length=10)
        out = "Answer: " + ans[0]
    else:
        params = (blip.blip_params_from_state_dict(sd) if sd is not None
                  else blip_lm.init_blip_itm_params(gen, cfg)).to(device)
        enc = tok([args.caption], max_length=35)
        # the ITM head reads the tokenised caption as it is: [CLS] first
        ids = torch.as_tensor(enc["input_ids"].astype(np.int64), device=device)
        mask = torch.as_tensor(np.asarray(enc["attention_mask"], np.int64), device=device)
        with torch.no_grad():
            itm = blip.blip_itm_score(params, img, ids, mask, cfg, match_head="itm")
            p = float(torch.softmax(itm.float(), dim=1)[0, 1])
            itc = float(blip.blip_itm_score(params, img, ids, mask, cfg, match_head="itc")[0, 0])
        out = (f"The image and text is matched with a probability of {p:.4f}.\n"
               f"The image feature and text feature has a cosine similarity of {itc:.4f}.")
    print(out)
    return out


if __name__ == "__main__":
    main()
